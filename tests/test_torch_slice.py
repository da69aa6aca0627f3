"""The port's serving slice against the JAX package's, end to end.

The Pots->Vaih leaf config is loaded by both packages' ``Config``,
narrowed to tiny widths as ``__graft_entry__._flagship_cfg(tiny=True)``
does, and given the same numpy-seeded weights. Requests go through
``make_inference_fn`` + ``_finalize_views`` and ``make_state_fn`` on
both sides. Tolerances: labels identical wherever the top-2 probability
margin exceeds 1e-4; probabilities atol 1e-5 (softmax of fp32 logits
that agree to ~1e-6); ``sim_feat`` atol 1e-5.
"""
import glob
import os.path as osp
import subprocess
import sys

import numpy as np
import pytest
import torch

# torch's OpenMP pool must not run beside XLA-CPU in one process
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_parity import jax_variables, load_port, nchw, nhwc  # noqa: E402

from pfst_tpu.apis import inference as jax_inference  # noqa: E402
from pfst_tpu.apis import test as jax_test  # noqa: E402
from pfst_tpu.ops.resize import resize as jax_resize  # noqa: E402
from pfst_tpu.utils import Config as JaxConfig  # noqa: E402
from pfst_tpu_torch import ops  # noqa: E402
from pfst_tpu_torch.apis import (_finalize_views, init_segmentor,  # noqa: E402
                                 make_inference_fn, make_state_fn)
from pfst_tpu_torch.apis.test import _view_probs  # noqa: E402
from pfst_tpu_torch.utils import Config  # noqa: E402

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
LEAF = osp.join(REPO, 'configs', 'pfst',
                'pfst_pots_irrg2vaih_irrg_deeplabv3plus_r50-d8.py')
# the widths __graft_entry__._flagship_cfg(tiny=True) gives the leaf model
TINY = {
    'model.backbone.depth': 18, 'model.backbone.base_channels': 8,
    'model.backbone.stem_channels': 8,
    'model.decode_head.in_channels': 64, 'model.decode_head.channels': 16,
    'model.decode_head.c1_in_channels': 8,
    'model.decode_head.c1_channels': 4,
    'model.auxiliary_head.in_channels': 32,
    'model.auxiliary_head.channels': 8,
}


@pytest.mark.parametrize('path', sorted(glob.glob(
    osp.join(REPO, 'configs', 'pfst', '*.py'))), ids=osp.basename)
def test_config_fromfile_matches_jax(path):
    assert Config.fromfile(path).to_dict() == \
        JaxConfig.fromfile(path).to_dict()


@pytest.fixture(scope='module')
def slice_pair():
    jcfg, pcfg = JaxConfig.fromfile(LEAF), Config.fromfile(LEAF)
    jcfg.merge_from_dict(TINY)
    pcfg.merge_from_dict(TINY)
    jmodel, _ = jax_inference.init_segmentor(jcfg)
    variables = jax_variables(jmodel, (1, 64, 64, 3), seed=7)
    port = load_port(init_segmentor(pcfg, device='cpu'), variables)
    return jmodel, variables, port


def _requests():
    """Two requests: one plain view at its own size, one with a
    horizontal-flip TTA view, rescaled to another ``ori_shape``."""
    rs = np.random.RandomState(11)
    a = rs.randn(1, 64, 64, 3).astype(np.float32)
    b = rs.randn(1, 48, 64, 3).astype(np.float32)
    return [
        ([a], [{'flip': False}], (64, 64)),
        ([b, b[:, :, ::-1].copy()],
         [{'flip': False},
          {'flip': True, 'flip_direction': 'horizontal'}], (61, 83)),
    ]


def _jax_probs(jmodel, view_logits, metas, ori_shape):
    """The summed probabilities ``pfst_tpu.apis.test._finalize_views``
    takes the argmax of (``test.py:104-117``)."""
    acc = 0
    for logits, meta in zip(view_logits, metas):
        if meta.get('flip'):
            logits = jnp.flip(logits, axis=2)
        if tuple(logits.shape[1:3]) != tuple(ori_shape):
            logits = jax_resize(logits, size=ori_shape, mode='bilinear',
                                align_corners=jmodel.align_corners)
        acc = acc + jax.nn.softmax(logits, axis=-1)
    return np.asarray(acc)


def test_serving_slice_matches_jax(slice_pair):
    jmodel, variables, port = slice_pair
    jinfer = jax_test.make_inference_fn(jmodel)
    infer = make_inference_fn(port)
    launches = ops.cuda_neighborhood_similarity.launches
    for views, metas, ori_shape in _requests():
        jlogits = [jinfer(variables, jnp.asarray(v)) for v in views]
        jlabels = jax_test._finalize_views(jmodel, jlogits, metas, ori_shape)
        jprobs = _jax_probs(jmodel, jlogits, metas, ori_shape)[0]
        plogits = [infer(nchw(v)) for v in views]
        labels = _finalize_views(port, plogits, metas, ori_shape)
        probs = nhwc(_view_probs(port, plogits, metas, ori_shape))[0]
        assert labels.shape == tuple(ori_shape) == jlabels.shape
        np.testing.assert_array_equal(jlabels, jprobs.argmax(-1))
        np.testing.assert_allclose(probs, jprobs, atol=1e-5, rtol=0)
        top2 = np.sort(jprobs, axis=-1)[..., -2:]
        sure = (top2[..., 1] - top2[..., 0]) > 1e-4
        assert sure.mean() > 0.9
        np.testing.assert_array_equal(labels[sure], jlabels[sure])
    # on the CPU the slice never reaches the CUDA kernel
    assert ops.cuda_neighborhood_similarity.launches == launches


@pytest.mark.parametrize('sim_cfg', [
    None, dict(kernel_size=5, dilation=1, sim_type='cosine')])
def test_state_fn_matches_jax(slice_pair, sim_cfg):
    jmodel, variables, port = slice_pair
    for views, _, _ in _requests():
        ref = jax_test.make_state_fn(jmodel, sim_cfg)(
            variables, jnp.asarray(views[0]))
        st = make_state_fn(port, sim_cfg)(nchw(views[0]))
        k2 = 9 if sim_cfg is None else 25
        h, w = views[0].shape[1] // 8, views[0].shape[2] // 8  # OS 8
        assert st['sim_feat'].shape == (1, k2, h, w)
        assert st['sim_feat'].dtype == torch.float32
        np.testing.assert_allclose(nhwc(st['sim_feat']), ref['sim_feat'],
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(nhwc(st['decoded_features']),
                                   ref['decoded_features'],
                                   atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(nhwc(st['seg_logits']),
                                   ref['seg_logits'], atol=1e-4, rtol=1e-4)


def test_init_segmentor_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        init_segmentor(LEAF)


def test_port_imports_no_jax_flax_cv2_or_jax_package():
    """Every module of the port (the attention, ViT, neck, UPerHead,
    trainer, UDA family and its losses and replay, the domain adaptors with
    their discriminator, losses and optimizer options, data (the EO
    datasets, the TIFF and HDF5 readers and the wrappers too), the hooks
    and the pseudo-label generator, the logger hooks and their event
    writer, LoveDA, the environment utilities, the SETR, Segmenter, DPT,
    PSPNet, Semantic-FPN and ANN heads and the MLA and FPN necks, the MiT
    and Twins backbones and the SegFormer head, the CNN backbones, the
    LR-ASPP head and ICNet's neck, the attention and context heads, the
    PSA mask, the encoding layer and the JPU, the cascade, point sampling,
    the pixel sampler, the Dice, focal and Lovasz losses, quantization,
    BN folding, ResNeXt, ResNeSt and the timm adapter, data parallelism
    (``parallel``: the group, the sharded step's collectives, SyncBN,
    the sharded slide inference), the sharded modes (their collectives,
    the GSPMD global batch, tensor parallelism, ZeRO, GPipe, the MoE,
    spatial inference), evaluation, checkpoint and
    host-kernel modules named, so that a missing one fails), the port's
    tools but the JAX checkpoint converter (which imports both packages by
    design) and chip_smoke.py, in a fresh process: none of jax, flax,
    optax, orbax, cv2, PIL, h5py, tensorflow, tensorboard, wandb or the
    JAX package."""
    code = '\n'.join([
        'import importlib, pkgutil, sys',
        'import pfst_tpu_torch',
        'for m in pkgutil.walk_packages(pfst_tpu_torch.__path__, ',
        "                               'pfst_tpu_torch.'):",
        '    importlib.import_module(m.name)',
        "for m in ('ops.attention', 'models.backbones.vit', 'models.necks',",
        "          'models.decode_heads.uper_head', 'apis.train',",
        "          'apis.test', 'apis.inference', 'core.checkpoint',",
        "          'core.evaluation.metrics', 'datasets.builder',",
        "          'datasets.custom', 'datasets.isprs',",
        "          'datasets.uda_dataset', 'datasets.pipelines.loading',",
        "          'datasets.pipelines.packing', 'datasets.pipelines.png',",
        "          'datasets.pipelines.transforms', 'native.hostaug',",
        "          'datasets.eo_dataset', 'datasets.inria',",
        "          'datasets.season_net', 'datasets.uda_dataset_v2',",
        "          'datasets.pipelines.tiff', 'datasets.pipelines.imdecode',",
        "          'core.evaluation.class_names', 'models.uda.dacs',",
        "          'models.uda.pfst', 'models.uda.pgst', 'models.uda.fmda',",
        "          'models.losses.pfst_loss', 'models.losses.feat_sim_loss',",
        "          'models.utils.pfst_transforms',",
        "          'models.segmentors.domain_adaptor',",
        "          'models.discriminators.fc_discriminator',",
        "          'models.losses.adv_loss', 'models.losses.entropy_loss',",
        "          'models.losses.pseudo_label_loss', 'core.optimizers',",
        "          'datasets.dataset_wrappers', 'datasets.pipelines.h5',",
        "          'core.hooks', 'core.hooks.hook', 'core.hooks.loggers',",
        "          'core.hooks.pseudo_labeling_hook',",
        "          'core.hooks.rare_class_sampling_hook',",
        "          'core.hooks.plot_statistics_hook', 'apis.pseudo_labels',",
        "          'core.hooks.tb_events', 'datasets.loveda',",
        "          'utils.collect_env', 'utils.set_env',",
        "          'models.decode_heads.transformer_heads',",
        "          'models.decode_heads.point_rend',",
        "          'models.decode_heads.psp_head',",
        "          'models.decode_heads.fcn_head',",
        "          'models.decode_heads.context_heads',",
        "          'models.necks.mla_neck', 'models.necks.fpn',",
        "          'models.backbones.mit', 'models.backbones.twins',",
        "          'models.decode_heads.segformer_head',",
        "          'models.backbones.unet', 'models.backbones.hrnet',",
        "          'models.backbones.convnext', 'models.backbones.mobilenet',",
        "          'models.backbones.fast_cnns', 'models.necks.ic_neck',",
        "          'models.decode_heads.lraspp_head',",
        "          'models.decode_heads.attention_heads',",
        "          'models.decode_heads.isa_cc_heads',",
        "          'models.decode_heads.enc_head', 'models.necks.jpu',",
        "          'ops.psa_mask', 'ops.encoding', 'ops.point_sample',",
        "          'core.seg', 'core.seg.sampler',",
        "          'models.segmentors.cascade_encoder_decoder',",
        "          'models.losses.dice_loss', 'models.losses.focal_loss',",
        "          'models.losses.lovasz_loss', 'models.backbones.resnet',",
        "          'ops.quant', 'core.fold_bn', 'models.backbones.resnext',",
        "          'models.backbones.resnest',",
        "          'models.backbones.timm_backbone', 'parallel',",
        "          'parallel.mesh', 'parallel.sync_bn', 'parallel.slide',",
        "          'parallel.comm', 'parallel.global_batch', 'parallel.tp',",
        "          'parallel.zero', 'parallel.pp', 'parallel.ep',",
        "          'parallel.spatial'):",
        "    importlib.import_module('pfst_tpu_torch.' + m)",
        "sys.path.insert(0, 'tools')",
        'import attn_microbench_torch',
        'import make_synthetic_data_torch, pack_dataset_torch',
        'import train_torch, test_torch',
        'import gen_pseudo_labels_torch, compute_class_stats_torch',
        'import print_config_torch, confusion_matrix_torch',
        'import browse_dataset_torch, get_flops_torch',
        'import publish_model_torch, bench_loader_torch',
        'import trace_step_torch, grad_conditioning_torch',
        'import calibrate_int8_torch, int8_microbench_torch',
        'import benchmark_torch',
        'import chip_smoke',
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in",
        "             ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'cv2',",
        "              'PIL', 'h5py', 'pfst_tpu', 'tensorflow',",
        "              'tensorboard', 'wandb'))",
        'print(len(sys.modules), bad)',
        'sys.exit(1 if bad else 0)',
    ])
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
