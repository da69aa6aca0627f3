"""The rest of A12 in the port against the JAX package, on the CPU.

* the PFGST step's visualisation states (``collect_vis``) against the JAX
  step's on the golden-trace recipe of ``tests/test_torch_train.py`` (the
  port's premix given to both steps, no blur): images and labels exact,
  the density map rtol 1e-3, atol 3e-5, the argmax maps equal wherever
  the port's top two logits are more than 1e-3 apart (ties aside);
* the TensorBoard event file against the JAX hook's: the JAX hook writes
  through a stand-in ``tensorflow`` whose ``tf.summary.scalar`` is
  TensorBoard's own TF-free scalar summary (``scalar_pb``) and record
  writer (importing tensorflow takes longer than this whole file), both
  files read with TensorBoard's ``event_pb2``: the same (tag, step,
  value) set, the values equal as float32;
* the W&B payload against the JAX hook's through one stand-in ``wandb``:
  the scalars equal, the images and histograms bit-equal;
* ``RandomRotate``, ``CLAHE``, ``AdjustGamma`` and ``SegRescale`` against
  the JAX classes (cv2 5.0) bit-exact, on odd sizes, one to four
  channels, several angles, clip limits and grids that do not divide the
  image (the warp also on uint16 and float32 images); the float
  transforms exact;
* the 16-bit PNG and float32 TIFF reads equal to cv2's, and the GTA,
  depth and Inria annotation loaders equal to the JAX ones;
* ``format_results`` PNGs that decode equal to the JAX ones;
* LoveDA and ``MultiImageMixDataset`` giving the JAX items under the same
  ``np.random`` seed;
* ``tools/get_flops_torch.py`` counting the JAX tool's parameters
  exactly, and the other user tools against their JAX counterparts;
* ``ProfilerHook`` writing a CPU trace, and refusing a trace without
  kernels where the student is on the card.
"""
import contextlib
import glob
import os
import os.path as osp
import struct
import sys
import time
import types

import numpy as np
import pytest
import torch

# torch's OpenMP pool must not run beside XLA-CPU in one process
torch.set_num_threads(1)

import cv2  # noqa: E402
import jax  # noqa: E402

from conftest import tiny_model_cfg  # noqa: E402
from test_torch_train import (MEAN, STD, _port_premix,  # noqa: E402,F401
                              _torch_batch, jax_state, jax_step)
from torch_parity import jax_variables  # noqa: E402

from pfst_tpu.core.hooks import loggers as jax_loggers  # noqa: E402
from pfst_tpu.datasets import dataset_wrappers as jax_wrappers  # noqa: E402
from pfst_tpu.datasets import loveda as jax_loveda  # noqa: E402
from pfst_tpu.datasets.pipelines import loading as jax_loading  # noqa: E402
from pfst_tpu.datasets.pipelines import transforms as jax_tf  # noqa: E402
from pfst_tpu.models import build_segmentor as jax_segmentor  # noqa: E402
from pfst_tpu_torch.core.hooks import loggers  # noqa: E402
from pfst_tpu_torch.core.hooks import tb_events  # noqa: E402
from pfst_tpu_torch.datasets import (LoveDADataset,  # noqa: E402
                                     MultiImageMixDataset, build_dataset)
from pfst_tpu_torch.datasets.pipelines import loading  # noqa: E402
from pfst_tpu_torch.datasets.pipelines import transforms as tf  # noqa: E402
from pfst_tpu_torch.datasets.pipelines import imread  # noqa: E402
from pfst_tpu_torch.models import build_segmentor  # noqa: E402
from pfst_tpu_torch.utils import Config  # noqa: E402

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, osp.join(REPO, 'tools'))

import bench_loader_torch  # noqa: E402
import browse_dataset as jax_browse  # noqa: E402
import browse_dataset_torch  # noqa: E402
import confusion_matrix as jax_confusion  # noqa: E402
import confusion_matrix_torch  # noqa: E402
import get_flops_torch  # noqa: E402
import print_config as jax_print_config  # noqa: E402
import print_config_torch  # noqa: E402
import publish_model_torch  # noqa: E402

PALETTE = [[255, 255, 255], [255, 0, 0], [255, 255, 0], [0, 0, 255],
           [159, 129, 183], [0, 255, 0], [255, 195, 128]]


# ------------------------------ the PFGST step ------------------------------
@pytest.mark.parametrize('thre_type', ['all', 'part'])
def test_pfgst_step_vis_states_match_jax(jax_state, jax_step, thre_type):
    """With ``thre_type='part'`` the pseudo-label weight is 0 at the
    teacher's unconfident pixels, where the mixed labels show 255."""
    _, _, jstate, batch = jax_state
    algo, state, premix, gen = _port_premix(thre_type, jstate, batch,
                                            jax.random.PRNGKey(7))
    forward, logits = state.student.forward_train, []

    def recording(*args, **kwargs):
        out = forward(*args, **kwargs)
        logits.append(out[1]['seg_logits'].detach())
        return out

    state.student.forward_train = recording
    _, _, vis = algo.make_train_step(MEAN, STD, collect_vis=True)(
        state, _torch_batch(batch), gen, premix=premix)
    ref = jax_step[thre_type][2]
    assert sorted(vis) == sorted(ref) == [
        'vis|density_sim_feat', 'vis|seg_mask_mix', 'vis|seg_mask_src']
    got = {k: [loggers.to_jax_layout(t) for t in v] for k, v in vis.items()}
    want = {k: [np.asarray(a) for a in v] for k, v in ref.items()}
    for k in want:
        assert [a.shape for a in got[k]] == [a.shape for a in want[k]], k
        assert [a.dtype.kind for a in got[k]] == \
            [a.dtype.kind for a in want[k]], k
    # (images, labels, argmax): the source pass's and the mixed pass's
    for k, lg in (('vis|seg_mask_src', logits[0]),
                  ('vis|seg_mask_mix', logits[1])):
        np.testing.assert_array_equal(got[k][0], want[k][0])
        np.testing.assert_array_equal(got[k][1], want[k][1])
        top2 = lg.topk(2, dim=1).values
        clear = (top2[:, 0] - top2[:, 1] > 1e-3).numpy()
        assert clear.mean() > 0.9
        np.testing.assert_array_equal(got[k][2][clear], want[k][2][clear])
    unweighted = premix['pseudo_weight'].numpy() == 0
    assert unweighted.any() == (thre_type == 'part')
    assert (got['vis|seg_mask_mix'][1][unweighted] == 255).all()
    assert (got['vis|seg_mask_mix'][1] == 255).any()
    img, density, mask = got['vis|density_sim_feat']
    np.testing.assert_array_equal(img, want['vis|density_sim_feat'][0])
    np.testing.assert_allclose(density, want['vis|density_sim_feat'][1],
                               rtol=1e-3, atol=3e-5)
    np.testing.assert_array_equal(mask, want['vis|density_sim_feat'][2])


# ------------------------------- TensorBoard --------------------------------
@contextlib.contextmanager
def _tensorflow_from_tensorboard(monkeypatch):
    """A ``tensorflow`` module with the ``tf.summary`` calls of the JAX
    hook: ``scalar`` writes TensorBoard's own scalar summary (a float32
    tensor under the 'scalars' plugin, what TF2 writes) with TensorBoard's
    TF-free record writer, after a file-version event."""
    from tensorboard.compat.proto import event_pb2
    from tensorboard.plugins.scalar.summary_v2 import scalar_pb
    from tensorboard.summary.writer.record_writer import RecordWriter
    summary = types.SimpleNamespace(default=None, writers=[])

    class Writer:
        def __init__(self, logdir):
            os.makedirs(logdir, exist_ok=True)
            self.records = RecordWriter(
                open(osp.join(logdir, 'events.out.tfevents.jax'), 'wb'))
            self.add(event_pb2.Event(wall_time=time.time(),
                                     file_version='brain.Event:2'))
            summary.writers.append(self)

        def add(self, event):
            self.records.write(event.SerializeToString())

        @contextlib.contextmanager
        def as_default(self):
            summary.default = self
            yield

        def flush(self):
            self.records.flush()

    def scalar(name, data, step):
        summary.default.add(event_pb2.Event(
            wall_time=time.time(), step=step, summary=scalar_pb(name, data)))

    summary.create_file_writer = Writer
    summary.scalar = scalar
    module = types.ModuleType('tensorflow')
    module.summary = summary
    monkeypatch.setitem(sys.modules, 'tensorflow', module)
    try:
        yield
    finally:
        for w in summary.writers:
            w.records.close()


def _scalars(path):
    """{(tag, step, float32 bytes)} of an event file, read with
    TensorBoard's protobuf classes (simple values or scalar tensors)."""
    from tensorboard.compat.proto import event_pb2
    from tensorboard.util.tensor_util import make_ndarray
    raw, pos, out = open(path, 'rb').read(), 0, set()
    while pos < len(raw):
        (n,) = struct.unpack('<Q', raw[pos:pos + 8])
        event = event_pb2.Event.FromString(raw[pos + 12:pos + 12 + n])
        pos += 16 + n
        for v in event.summary.value:
            value = v.simple_value if v.WhichOneof('value') == \
                'simple_value' else make_ndarray(v.tensor)
            out.add((v.tag, event.step, np.float32(value).tobytes()))
    return out


def test_event_file_matches_the_jax_hook(tmp_path, monkeypatch):
    from tensorboard.compat.tensorflow_stub.pywrap_tensorflow import \
        masked_crc32c
    assert tb_events.crc32c(b'123456789') == 0xE3069283   # the check value
    for data in (b'', b'\x00' * 8, bytes(range(256))):
        assert tb_events.masked_crc32c(data) == masked_crc32c(data)
    rs = np.random.RandomState(0)
    port = loggers.TensorboardLoggerHook(interval=4)
    port.before_run({'work_dir': str(tmp_path / 'port')})
    with _tensorflow_from_tensorboard(monkeypatch):
        ref = jax_loggers.TensorboardLoggerHook(interval=4)
        ref.before_run({'work_dir': str(tmp_path / 'jax')})
        for it in range(1, 13):
            lv = {k: np.float32(rs.randn() * 10.0**rs.randint(-8, 4))
                  for k in ('loss', 'decode.loss_ce', 'decode.acc_seg',
                            'mix.loss_sim_pos')}
            ref.after_train_iter({'iter': it}, lv)
            port.after_train_iter(
                {'iter': it}, {k: torch.tensor(v) for k, v in lv.items()})
        ref.after_run({})
    port.after_run({})
    (jax_file,) = glob.glob(str(tmp_path / 'jax' / 'tb' / 'events.*'))
    (port_file,) = glob.glob(str(tmp_path / 'port' / 'tb' /
                                 'events.out.tfevents.*'))
    want = _scalars(jax_file)
    assert len(want) == 12 and _scalars(port_file) == want
    events = tb_events.read_events(port_file)
    assert events[0]['file_version'] == 'brain.Event:2'
    assert [e['step'] for e in events] == [0, 4, 8, 12]
    assert {(t, e['step'], np.float32(v).tobytes()) for e in events
            for t, v in e['scalars']} == want
    with open(port_file, 'rb') as f:
        raw = bytearray(f.read())
    raw[-5] ^= 1                            # a bit of the last record
    with open(port_file, 'wb') as f:
        f.write(raw)
    with pytest.raises(ValueError, match='CRC'):
        tb_events.read_events(port_file)


# ----------------------------------- W&B ------------------------------------
class _Wandb(types.ModuleType):
    """A stand-in ``wandb`` module recording what it is given."""

    def __init__(self):
        super().__init__('wandb')
        self.logged = []
        self.Image = lambda a: ('image', np.array(a))
        self.Histogram = lambda a: ('histogram', np.array(a))

    def init(self, **kwargs):
        pass

    def log(self, payload, step=None):
        self.logged.append((step, payload))

    def finish(self):
        pass


def _vis_states(rs, b=3, h=12, w=10):
    """The JAX step's kinds of states (NHWC), and the port's (NCHW)."""
    img = rs.randn(b, h, w, 3).astype(np.float32)
    gt = rs.randint(0, 7, (b, h, w)).astype(np.int32)
    gt[:, 0] = 255
    pred = rs.randint(0, 7, (b, h, w)).astype(np.int32)
    small = rs.randint(0, 7, (b, h // 2, w // 2)).astype(np.int32)
    density = rs.rand(b, h // 2, w // 2, 1).astype(np.float32)
    hist = (['a', 'b'], [rs.rand(20).astype(np.float32),
                         rs.rand(30).astype(np.float32)])
    ref = {'vis|seg_mask_src': (img, gt, pred),
           'vis|seg_mask_mix': (img, gt, small),
           'vis|density_sim_feat': (img, density, density > 0.5),
           'vis|hist_sim': hist}

    def port(a):
        t = torch.from_numpy(a)
        return t.permute(0, 3, 1, 2) if t.dim() == 4 else t

    ours = {k: tuple(port(a) for a in v) for k, v in ref.items()
            if 'hist' not in k}
    ours['vis|hist_sim'] = (hist[0], [torch.from_numpy(a) for a in hist[1]])
    return ref, ours


def test_wandb_payload_matches_the_jax_hook(monkeypatch):
    wandb = _Wandb()
    monkeypatch.setitem(sys.modules, 'wandb', wandb)
    rs = np.random.RandomState(0)
    ref_states, port_states = _vis_states(rs)
    lv = {'loss': np.float32(1.5), 'decode.acc_seg': np.float32(71.25)}
    for hook, states, vars_ in (
            (jax_loggers.WandbHookSeg(interval=2), ref_states, lv),
            (loggers.WandbHookSeg(interval=2), port_states,
             {k: torch.tensor(v) for k, v in lv.items()})):
        hook.before_run({})
        for it in (1, 2):
            hook.after_train_iter({'iter': it, 'palette': PALETTE}, vars_,
                                  states)
        hook.after_run({})
    (step_j, want), (step_p, got) = wandb.logged
    assert step_j == step_p == 2
    # the mixed triplet's maps differ in height: both hooks leave it out
    assert sorted(got) == sorted(want) == sorted(
        ['loss', 'decode.acc_seg', 'vis|seg_mask_src/0',
         'vis|seg_mask_src/1', 'vis|density_sim_feat/0',
         'vis|density_sim_feat/1', 'vis|hist_sim/a', 'vis|hist_sim/b'])
    for k in want:
        if isinstance(want[k], tuple):
            assert got[k][0] == want[k][0], k
            assert got[k][1].dtype == want[k][1].dtype, k
            np.testing.assert_array_equal(got[k][1], want[k][1], err_msg=k)
        else:
            assert got[k] == want[k], k


# ------------------------------ the transforms ------------------------------
@pytest.mark.parametrize('shape,dtype', [
    ((37, 53, 1), 'uint8'), ((37, 53, 3), 'uint8'), ((64, 64, 1), 'uint8'),
    ((64, 64, 3), 'uint8'), ((33, 100, 4), 'uint8'),
    ((37, 53, 3), 'float32')])
def test_random_rotate_matches_jax(shape, dtype):
    """Six draws each, angles in [-180, 180], the image bilinear with a
    border of 7 (in the first channel), the labels nearest with 255."""
    rs = np.random.RandomState(sum(shape))
    for _ in range(6):
        img = rs.randint(0, 256, shape).astype(dtype)
        gt = rs.randint(0, 6, shape[:2]).astype(np.uint8)
        seed = rs.randint(2**31)
        out = []
        for cls in (jax_tf.RandomRotate, tf.RandomRotate):
            np.random.seed(seed)
            out.append(cls(prob=0.9, degree=180, pad_val=7)(
                {'img': img.copy(), 'gt_semantic_seg': gt.copy(),
                 'seg_fields': ['gt_semantic_seg']}))
        for k in ('img', 'gt_semantic_seg'):
            assert out[1][k].shape == out[0][k].shape, k
            np.testing.assert_array_equal(out[1][k], out[0][k], err_msg=k)


@pytest.mark.parametrize('angle', [0.0, 90.0, -90.0, 45.0, 180.0, 0.5])
def test_warp_affine_matches_cv2_at_exact_angles(angle):
    """Angles whose source points fall on or halfway between pixels
    (rounding ties), an off-centre point, widths on both sides of
    OpenCV's 16-column vector steps, uint8, uint16 and float32 images and
    border values cv2 saturates."""
    rs = np.random.RandomState(int(angle * 10) % 1000)
    for (h, w, c), dtype in zip(((36, 53, 3), (31, 16, 1), (20, 47, 4)),
                                (np.uint8, np.uint16, np.float32)):
        img = (rs.randn(h, w, c) * 300).astype(dtype) \
            if dtype == np.float32 else rs.randint(
                0, np.iinfo(dtype).max + 1, (h, w, c)).astype(dtype)
        # the last centre is not a float32 value: OpenCV rounds it to one
        for center in (((w - 1) * 0.5, (h - 1) * 0.5), (3.25, 11.5),
                       (3.3, 11.7)):
            m = cv2.getRotationMatrix2D(center, angle, 1.0)
            assert np.array_equal(tf.rotation_matrix(center, angle), m)
            for flag, nearest in ((cv2.INTER_LINEAR, False),
                                  (cv2.INTER_NEAREST, True)):
                for border in (200, 300.7, -3):
                    want = cv2.warpAffine(img, m, (w, h), flags=flag,
                                          borderValue=border)
                    got = tf.warp_affine(img, m, (w, h), nearest, border)
                    assert got.dtype == want.dtype
                    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('shape,clip,grid', [
    ((37, 53, 3), 40.0, (8, 8)), ((37, 53, 1), 2.0, (8, 8)),
    ((64, 64, 3), 4.0, (8, 8)), ((64, 64, 1), 1.0, (3, 5)),
    ((50, 31, 3), 0.0, (4, 4)), ((17, 200, 2), 3.0, (7, 3)),
    ((60, 60, 3), 2.5, (3, 3)), ((37, 64, 1), 4.0, (8, 8))])
def test_clahe_matches_jax(shape, clip, grid):
    """Among the cases: a clip limit whose ``clip * area / 256`` ends in
    .9 (truncated), and a grid that divides the width but not the height
    (OpenCV then pads the width by a whole tile count too)."""
    rs = np.random.RandomState(shape[0] + shape[1])
    img = rs.randint(0, 256, shape).astype(np.uint8)
    img[: shape[0] // 2] = img[: shape[0] // 2] // 4 + 60   # clipping
    out = [cls(clip, grid)({'img': img.copy()})['img']
           for cls in (jax_tf.CLAHE, tf.CLAHE)]
    np.testing.assert_array_equal(out[1], out[0])


@pytest.mark.parametrize('shape', [(37, 53, 3), (64, 64, 1), (37, 53)])
def test_adjust_gamma_and_seg_rescale_match_jax(shape):
    rs = np.random.RandomState(1)
    img = rs.randint(0, 256, shape).astype(np.uint8)
    for gamma in (0.5, 1.0, 2.2):
        out = [cls(gamma)({'img': img.copy()})['img']
               for cls in (jax_tf.AdjustGamma, tf.AdjustGamma)]
        assert out[1].shape == out[0].shape
        np.testing.assert_array_equal(out[1], out[0])
    gt = rs.randint(0, 6, shape[:2]).astype(np.uint8)
    for factor in (0.5, 2, 0.37, 1):
        out = [cls(factor)({'gt_semantic_seg': gt.copy(),
                            'seg_fields': ['gt_semantic_seg']})
               ['gt_semantic_seg'] for cls in (jax_tf.SegRescale,
                                               tf.SegRescale)]
        np.testing.assert_array_equal(out[1], out[0])


def test_float_transforms_match_jax():
    """The JAX file's numpy on the same inputs: equal."""
    rs = np.random.RandomState(2)
    img = rs.randint(0, 4096, (23, 41, 3)).astype(np.uint16)
    cfg = {'spring': dict(mean=[900.0, 800, 700], std=[300.0, 250, 200]),
           'fall': dict(mean=[1000.0, 900, 800], std=[350.0, 300, 250],
                        to_uint8=True)}
    cases = [
        ('PercentileNormalize', {}, {}),
        ('PercentileNormalize', dict(lo=5, hi=90), {}),
        ('Rerange', dict(min_value=-1, max_value=1), {}),
        ('RGB2Gray', {}, {}),
        ('RGB2Gray', dict(out_channels=1, weights=(0.2, 0.3, 0.5)), {}),
        ('MultiDomainClipNormalize', dict(norm_cfg_dict=cfg), dict(
            domain='fall')),
        ('MultiDomainClipNormalize', dict(norm_cfg_dict=cfg,
                                          default='spring'), {})]
    for name, kw, extra in cases:
        out = [getattr(mod, name)(**kw)({'img': img.copy(), **extra})['img']
               for mod in (jax_tf, tf)]
        assert out[1].dtype == out[0].dtype, name
        np.testing.assert_array_equal(out[1], out[0], err_msg=name)


# --------------------------------- loading ----------------------------------
def test_float_maps_read_as_cv2_and_the_loaders_match_jax(tmp_path):
    rs = np.random.RandomState(3)
    for shape in ((37, 53), (64, 64), (1, 7)):
        depth = rs.randint(0, 65536, shape).astype(np.uint16)
        depth.flat[0] = 65535
        agl = (rs.randn(*shape) * 300).astype(np.float32)
        agl.flat[0] = np.nan
        cv2.imwrite(str(tmp_path / 'gta.png'), depth)
        cv2.imwrite(str(tmp_path / 'tile_AGL.tif'), agl)
        for name in ('gta.png', 'tile_AGL.tif'):
            path = str(tmp_path / name)
            want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
            got = imread(path, unchanged=True)
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)
        for cls, seg_map in (('LoadAnnotationsGTA', 'gta.png'),
                             ('LoadAnnotationsDepth', 'tile_RGB.tif')):
            out = [getattr(mod, cls)()({
                'seg_prefix': str(tmp_path), 'seg_fields': [],
                'ann_info': {'seg_map': seg_map}})['gt_semantic_seg']
                for mod in (jax_loading, loading)]
            assert out[1].dtype == out[0].dtype == np.float32
            np.testing.assert_array_equal(out[1], out[0])
    gt = rs.randint(0, 256, (9, 11)).astype(np.uint8)
    out = [mod.AnnotationMapperInria()({'gt_semantic_seg': gt})
           ['gt_semantic_seg'] for mod in (jax_loading, loading)]
    np.testing.assert_array_equal(out[1], out[0])
    with pytest.raises(ValueError, match='16, colour type 0, color'):
        imread(str(tmp_path / 'gta.png'))


# ------------------------------ LoveDA and tools -----------------------------
@pytest.fixture(scope='module')
def loveda_root(tmp_path_factory):
    """A LoveDA-like tree: 5 train tiles of 32x48 (labels 0-7, 0 the
    no-data value) written by cv2."""
    root = tmp_path_factory.mktemp('loveda')
    rs = np.random.RandomState(4)
    for sub in ('img_dir/train', 'ann_dir/train'):
        os.makedirs(root / sub)
    for i in range(5):
        cv2.imwrite(str(root / 'img_dir/train' / f'{i}.png'),
                    rs.randint(0, 256, (32, 48, 3)).astype(np.uint8))
        cv2.imwrite(str(root / 'ann_dir/train' / f'{i}.png'),
                    rs.randint(0, 8, (32, 48)).astype(np.uint8))
    return str(root)


def _loveda_cfg(root, flip=False):
    pipeline = [dict(type='LoadImageFromFile'), dict(type='LoadAnnotations')]
    if flip:
        pipeline.append(dict(type='RandomFlip', prob=0.5))
    return dict(type='LoveDADataset', data_root=root,
                img_dir='img_dir/train', ann_dir='ann_dir/train',
                pipeline=pipeline)


def _assert_items_equal(got, want, where='item'):
    assert sorted(got) == sorted(want), where
    for k, v in want.items():
        if isinstance(v, dict):
            _assert_items_equal(got[k], v, f'{where}.{k}')
        elif isinstance(v, list) and v and isinstance(v[0], dict):
            for g, w in zip(got[k], v, strict=True):
                _assert_items_equal(g, w, f'{where}.{k}')
        elif isinstance(v, (np.ndarray, list, tuple)):
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v),
                                          err_msg=f'{where}.{k}')
        else:
            assert got[k] == v, f'{where}.{k}'


def test_loveda_and_multi_image_mix_give_the_jax_items(loveda_root):
    from pfst_tpu.datasets import build_dataset as jax_dataset
    pipeline = [dict(type='RandomFlip', prob=0.5, direction='vertical')]
    port = build_dataset(dict(type='MultiImageMixDataset',
                              dataset=_loveda_cfg(loveda_root, True),
                              pipeline=pipeline))
    ref = jax_wrappers.MultiImageMixDataset(
        jax_dataset(_loveda_cfg(loveda_root, True)), pipeline)
    assert isinstance(port, MultiImageMixDataset)
    assert isinstance(port.dataset, LoveDADataset)
    assert isinstance(ref.dataset, jax_loveda.LoveDADataset)
    assert port.CLASSES == ref.CLASSES and port.PALETTE == ref.PALETTE
    assert len(port) == len(ref) == 5
    for idx in (0, 3, 4):
        items = []
        for ds in (ref, port):
            np.random.seed(idx + 10)
            items.append(ds[idx])
        _assert_items_equal(items[1], items[0])


def test_format_results_write_the_jax_pngs(loveda_root, tmp_path):
    from pfst_tpu.datasets import build_dataset as jax_dataset
    rs = np.random.RandomState(5)
    results = [rs.randint(0, 7, (32, 48)) for _ in range(5)]
    to_label_id = {0: 10, 3: 30}
    port = build_dataset(_loveda_cfg(loveda_root))
    ref = jax_dataset(_loveda_cfg(loveda_root))
    for kw in ({}, {'to_label_id': to_label_id}):
        files = [ds.format_results(results, str(tmp_path / name), **kw)
                 for ds, name in ((ref, 'jax'), (port, 'port'))]
        assert [osp.basename(f) for f in files[1]] == \
            [osp.basename(f) for f in files[0]] == [f'{i}.png'
                                                    for i in range(5)]
        for got, want in zip(files[1], files[0]):
            np.testing.assert_array_equal(
                cv2.imread(got, cv2.IMREAD_UNCHANGED),
                cv2.imread(want, cv2.IMREAD_UNCHANGED))
    # the confusion matrix of those maps, with the JAX tool's function
    np.testing.assert_array_equal(
        confusion_matrix_torch.calculate_confusion_matrix(port, results),
        jax_confusion.calculate_confusion_matrix(ref, results))


def test_tools_match_their_jax_counterparts(loveda_root, tmp_path, capsys):
    cfg = Config(dict(data=dict(train=_loveda_cfg(loveda_root))))
    path = str(tmp_path / 'loveda.py')
    cfg.dump(path)
    text = print_config_torch.main([path])
    capsys.readouterr()
    jax_print_config.main([path])
    assert capsys.readouterr().out.strip() == text.strip()
    browse_dataset_torch.main([path, '--output-dir', str(tmp_path / 'p'),
                               '--num', '3'])
    jax_browse.main([path, '--output-dir', str(tmp_path / 'j'), '--num',
                     '3'])
    for i in range(3):
        name = f'sample_{i}.png'
        np.testing.assert_array_equal(
            imread(str(tmp_path / 'p' / name)),
            cv2.imread(str(tmp_path / 'j' / name)))
    s_batch = bench_loader_torch.bench(cfg, 2, 1, False, 1)
    assert s_batch > 0


def test_get_flops_counts_the_jax_parameters(tmp_path):
    """The JAX tool's count is ``sum(leaf.size)`` over ``params`` of the
    initialized model; ``jax.eval_shape`` gives those shapes without the
    init."""
    cfg = tiny_model_cfg()
    variables = jax_variables(jax_segmentor(cfg), (1, 64, 64, 3))
    want = sum(int(np.prod(x.shape))
               for x in jax.tree.leaves(variables['params']))
    cfg_path = str(tmp_path / 'tiny.py')
    Config(dict(model=cfg)).dump(cfg_path)
    flops, n_params = get_flops_torch.main(
        [cfg_path, '--shape', '64', '--device', 'cpu'])
    assert n_params == want == sum(
        p.numel() for p in build_segmentor(cfg).parameters())
    assert flops > 0


def test_publish_model_keeps_the_student(tmp_path):
    student = build_segmentor(tiny_model_cfg())
    sd = {f'model.{k}': v for k, v in student.state_dict().items()}
    sd.update({f'ema_model.{k}': v + 1 for k, v in
               student.state_dict().items() if v.is_floating_point()})
    src = str(tmp_path / 'iter_8.pth')
    torch.save({'meta': {'iter': 8}, 'state_dict': sd, 'optimizer': {}}, src)
    path, stamp = publish_model_torch.main([src, str(tmp_path / 'pub')])
    saved = torch.load(path, weights_only=True)
    assert saved['meta']['sha256'] == stamp == \
        publish_model_torch.digest(student.state_dict())
    assert saved.keys() == {'meta', 'state_dict'}
    for k, v in student.state_dict().items():
        assert torch.equal(saved['state_dict'][k], v), k


# --------------------------------- profiler ---------------------------------
def test_profiler_hook_traces_its_window(tmp_path, monkeypatch):
    hook = loggers.ProfilerHook(start_iter=2, num_steps=2, out_dir='prof')
    ctx = {'work_dir': str(tmp_path), 'state': None}
    x = torch.randn(64, 64)
    for it in range(1, 6):
        ctx['iter'] = it
        hook.after_train_iter(ctx, {})
        (x @ x).relu_()
    hook.after_run(ctx)
    assert hook.path == str(tmp_path / 'prof' / 'trace_iter_3-4.json')
    assert loggers.trace_kernels(hook.path) == []
    import json
    with open(hook.path) as f:
        names = {e.get('name') for e in json.load(f)['traceEvents']}
    assert 'aten::mm' in names
    # where the student is on the card, a trace without kernels raises
    monkeypatch.setattr(loggers, '_student_device',
                        lambda ctx: torch.device('cuda'))
    monkeypatch.setattr(torch.cuda, 'synchronize', lambda: None)
    hook = loggers.ProfilerHook(start_iter=1, num_steps=1)
    hook.after_train_iter({'iter': 1, 'work_dir': str(tmp_path)}, {})
    with pytest.raises(RuntimeError, match='no CUDA kernel'):
        hook.after_train_iter({'iter': 2, 'work_dir': str(tmp_path)}, {})


def test_environment_report_names_the_port_stack():
    from pfst_tpu_torch.utils.collect_env import collect_env
    from pfst_tpu_torch.utils.set_env import setup_environment
    setup_environment()
    env = collect_env()
    assert env['torch'] == torch.__version__
    for key in ('CUDA build', 'NVCC', 'GPU name, power limit'):
        assert key in env
    assert not any('jax' in k.lower() or 'xla' in k.lower() for k in env)
