"""Cross-replica batch norm (the JAX ``SyncBN``: flax ``BatchNorm`` with
``axis_name='data'``, ``pfst_tpu/models/utils/layers.py:19-47``).

``SyncBatchNorm`` is ``nn.BatchNorm2d`` with its state-dict keys. In
train mode inside ``sync_bn_group(group)`` with more than one rank in
``group`` its batch statistics are those of the whole global batch:

* forward: one ``all_reduce`` of the per-channel sums and the count, the
  mean, then one of the sums of squared deviations from it (the two-pass
  variance the port's BN and the tests' traces use, ROADMAP C2, not
  flax's default E[x²] − E[x]²);
* backward: one ``all_reduce`` of Σdy and Σdy·x̂; the weight and bias
  keep this rank's sums, which the step's gradient mean averages.

The running variance takes the unbiased variance over the global count,
as torch's BN does over its batch. Anywhere else, or at one rank, it is
``nn.BatchNorm2d``. Only ``all_reduce`` is used, so it runs on gloo with
CPU or CUDA tensors as on NCCL (``torch.nn.SyncBatchNorm`` refuses CPU
tensors).
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
import torch.nn as nn

_GROUP = [None]


@contextlib.contextmanager
def sync_bn_group(group):
    """``SyncBatchNorm`` layers reduce their statistics over ``group``
    while the context is open (the train step's, None for none). A GSPMD
    step's ``GlobalBatch`` (``global_batch.py``) opens its layout too, and
    its batch norms reduce over its data group inside a split forward
    only."""
    from .global_batch import global_batch, is_global_batch
    prev = _GROUP[0]
    _GROUP[0] = group
    try:
        with global_batch(group if is_global_batch(group) else None):
            yield
    finally:
        _GROUP[0] = prev


def _bn_group():
    group = _GROUP[0]
    return group.bn_group if hasattr(group, 'bn_group') else group


def _channel_sum(x):
    return x.sum(dim=(0, 2, 3))


class _CrossReplicaBatchNorm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, weight, bias, bn, group):
        xf = x.float()
        c = xf.shape[1]
        shape = (1, c, 1, 1)
        packet = torch.cat([_channel_sum(xf), xf.new_tensor(
            [xf.numel() // c])])
        dist.all_reduce(packet, group=group)
        n = packet[c]
        mean = packet[:c] / n
        centered = xf - mean.view(shape)
        sq = _channel_sum(centered * centered)
        dist.all_reduce(sq, group=group)
        var = sq / n
        invstd = torch.rsqrt(var + bn.eps)
        xhat = centered * invstd.view(shape)
        if bn.track_running_stats:
            with torch.no_grad():
                m = bn.momentum
                bn.running_mean.mul_(1 - m).add_(mean, alpha=m)
                bn.running_var.mul_(1 - m).add_(var * n / (n - 1), alpha=m)
                bn.num_batches_tracked.add_(1)
        ctx.save_for_backward(xhat, invstd, weight, n)
        ctx.group = group
        ctx.in_dtype = x.dtype
        return (xhat * weight.view(shape) + bias.view(shape)).to(
            torch.promote_types(x.dtype, weight.dtype))

    @staticmethod
    def backward(ctx, dy):
        xhat, invstd, weight, n = ctx.saved_tensors
        c = xhat.shape[1]
        shape = (1, c, 1, 1)
        g = dy.float()
        sum_dy = _channel_sum(g)
        sum_dy_xhat = _channel_sum(g * xhat)
        packet = torch.cat([sum_dy, sum_dy_xhat])
        dist.all_reduce(packet, group=ctx.group)
        mean_dy = (packet[:c] / n).view(shape)
        mean_dy_xhat = (packet[c:] / n).view(shape)
        dx = (weight * invstd).view(shape) * (g - mean_dy - xhat *
                                               mean_dy_xhat)
        return (dx.to(ctx.in_dtype), sum_dy_xhat.to(weight.dtype),
                sum_dy.to(weight.dtype), None, None)


class SyncBatchNorm(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train-mode statistics span the replicas of
    the open ``sync_bn_group``."""

    def forward(self, x):
        group = _bn_group()
        if not self.training or group is None or \
                dist.get_world_size(group) == 1:
            return super().forward(x)
        if self.momentum is None:
            raise ValueError('SyncBatchNorm takes a momentum')
        return _CrossReplicaBatchNorm.apply(x, self.weight, self.bias, self,
                                            group)
