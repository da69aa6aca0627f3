"""The port's data path against the JAX package's, on the same files and
seeds.

* ``imread`` equals ``cv2.imread`` exactly on PNGs that cv2 writes
  (grayscale, BGR, BGRA; widths 31, 64 and 100), and the port's pack
  reader equals ``pfst_tpu``'s ``packing.lookup`` exactly, on packs written
  by either package.
* ``imresize`` equals ``cv2.resize`` exactly (INTER_LINEAR and
  INTER_NEAREST on uint8; the exact 2x downscale included, which cv2 runs
  as INTER_AREA). So no pixel of a resized image differs.
* The source and target pipelines of the leaf config, at 128x128 tiles
  and 64x64 crops, for 4 seeds with ``np.random.seed`` set before each
  sample on both sides, host or uint8-wire normalization: label maps,
  metas and images identical (the port's images are CHW). The JAX
  pipeline runs its ``Resize`` with ``override_scale=True``: without it,
  it never draws the ratio-range scale after ``LoadImageFromFile``
  (ROADMAP C2). At width 64 the HSV round trip is bit-exact to cv2.
* ``eval_metrics`` and ``CustomDataset.evaluate`` give identical IoU,
  Acc and mIoU from the same predictions.
* The loader's index stream, with and without ``set_position(k)``,
  equals the JAX ``DataLoader``'s.
"""
import copy
import os.path as osp

import numpy as np
import pytest
import torch

# torch's OpenMP pool must not run beside XLA-CPU in one process
torch.set_num_threads(1)

import cv2  # noqa: E402

from pfst_tpu.core.evaluation import eval_metrics as jax_eval_metrics  # noqa: E402
from pfst_tpu.datasets import DataLoader as JaxDataLoader  # noqa: E402
from pfst_tpu.datasets import ISPRSDataset as JaxISPRS  # noqa: E402
from pfst_tpu.datasets.pipelines import Compose as JaxCompose  # noqa: E402
from pfst_tpu.datasets.pipelines import packing as jax_packing  # noqa: E402
from pfst_tpu.datasets.pipelines.transforms import _hsv_modify  # noqa: E402
from pfst_tpu.utils import Config as JaxConfig  # noqa: E402
from pfst_tpu_torch.core.evaluation import eval_metrics  # noqa: E402
from pfst_tpu_torch.datasets import DataLoader, ISPRSDataset  # noqa: E402
from pfst_tpu_torch.datasets.pipelines import Compose, imread  # noqa: E402
from pfst_tpu_torch.datasets.pipelines import packing  # noqa: E402
from pfst_tpu_torch.datasets.pipelines.png import (UnsupportedImage,  # noqa: E402
                                                   write_png)
from pfst_tpu_torch.datasets.pipelines.transforms import imresize  # noqa: E402
from pfst_tpu_torch.native import hostaug  # noqa: E402

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
DATA_CFG = osp.join(REPO, 'configs', '_base_', 'datasets',
                    'pots_irrg2vaih_irrg.py')
CHANNELS = {'gray': None, 'bgr': 3, 'bgra': 4}


def _image(rs, h, w, channels):
    shape = (h, w) if channels is None else (h, w, channels)
    return rs.randint(0, 256, shape).astype(np.uint8)


@pytest.mark.parametrize('width', [31, 64, 100])
@pytest.mark.parametrize('kind', sorted(CHANNELS))
def test_imread_matches_cv2(tmp_path, kind, width):
    rs = np.random.RandomState(width)
    path = str(tmp_path / f'{kind}.png')
    cv2.imwrite(path, _image(rs, 23, width, CHANNELS[kind]))
    modes = [(cv2.IMREAD_COLOR, {}), (cv2.IMREAD_UNCHANGED,
                                      dict(unchanged=True))]
    if kind == 'gray':
        modes.append((cv2.IMREAD_GRAYSCALE, dict(color=False)))
    for flag, kwargs in modes:
        ref = cv2.imread(path, flag)
        got = imread(path, **kwargs)
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert np.array_equal(got, ref), (kind, width, flag)


def test_imread_refuses_other_formats(tmp_path):
    path = str(tmp_path / 'a.jpg')
    cv2.imwrite(path, np.zeros((8, 8, 3), np.uint8))
    with pytest.raises(UnsupportedImage, match='pack_dataset.py'):
        imread(path)


def test_write_png_reads_back_in_cv2(tmp_path):
    rs = np.random.RandomState(0)
    for kind, channels in CHANNELS.items():
        img = _image(rs, 17, 45, channels)
        path = str(tmp_path / f'{kind}.png')
        write_png(path, img)
        assert np.array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), img)


@pytest.mark.parametrize('writer', ['port', 'jax'])
def test_pack_reader_matches_jax_lookup(tmp_path, writer):
    rs = np.random.RandomState(1)
    for kind, channels in CHANNELS.items():
        cv2.imwrite(str(tmp_path / f'{kind}.png'),
                    _image(rs, 19, 33, channels))
    pack = packing if writer == 'port' else jax_packing
    assert pack.pack_directory(str(tmp_path)) == 3
    packing.invalidate()
    jax_packing.invalidate()
    for kind in CHANNELS:
        path = str(tmp_path / f'{kind}.png')
        for color, unchanged in ((True, False), (False, False),
                                 (True, True)):
            got = packing.lookup(path, color, unchanged)
            ref = jax_packing.lookup(path, color, unchanged)
            assert (got is None) == (ref is None), (kind, color, unchanged)
            if ref is not None:
                assert got.dtype == ref.dtype
                assert np.array_equal(got, ref), (kind, color, unchanged)


@pytest.mark.parametrize('size', [(288, 288), (512, 512), (1152, 1152),
                                  (45, 23), (100, 100), (64, 64)])
def test_imresize_matches_cv2(size):
    rs = np.random.RandomState(size[0])
    for shape in ((128, 128, 3), (97, 61, 3), (128, 128)):
        img = rs.randint(0, 256, shape).astype(np.uint8)
        for interp, flag in (('bilinear', cv2.INTER_LINEAR),
                             ('nearest', cv2.INTER_NEAREST)):
            ref = cv2.resize(img, size, interpolation=flag)
            assert np.array_equal(imresize(img, size, interp), ref), \
                (shape, size, interp)


def test_hsv_round_trip_matches_cv2_at_width_64():
    rs = np.random.RandomState(2)
    img = rs.randint(0, 256, (48, 64, 3)).astype(np.uint8)
    sat = np.clip(np.arange(256) * 1.3, 0, 255).astype(np.uint8)
    hue = ((np.arange(256) + 7) % 180).astype(np.uint8)
    for s, h in ((sat, None), (None, hue), (sat, hue)):
        assert np.array_equal(hostaug.hsv_modify(img, s, h),
                              _hsv_modify(img, s, h))


@pytest.fixture(scope='module')
def tiles(tmp_path_factory):
    root = tmp_path_factory.mktemp('tiles')
    rs = np.random.RandomState(0)
    for d in ('img', 'ann'):
        (root / d).mkdir()
    for i in range(2):
        img = np.clip(rs.rand(128, 128, 3) * 255, 0, 255).astype(np.uint8)
        cv2.imwrite(str(root / 'img' / f't{i}.png'), img)
        cv2.imwrite(str(root / 'ann' / f't{i}.png'),
                    rs.randint(0, 7, (128, 128)).astype(np.uint8))
    return str(root)


def _small(pipeline, scale):
    out = copy.deepcopy(pipeline)
    for t in out:
        if t['type'] == 'Resize':
            t['img_scale'] = scale
        if t['type'] in ('RandomCrop', 'Pad'):
            t['crop_size' if t['type'] == 'RandomCrop' else 'size'] = (64, 64)
    return out


def _assert_same(port, ref, what):
    assert port.keys() == ref.keys()
    for key in ref:
        if key.endswith('img_metas'):
            assert port[key].keys() == ref[key].keys()
            for mk, mv in ref[key].items():
                pv = port[key][mk]
                if isinstance(mv, dict):
                    assert {k: np.asarray(v).tolist() for k, v in
                            pv.items()} == {k: np.asarray(v).tolist()
                                            for k, v in mv.items()}
                else:
                    assert np.array_equal(np.asarray(pv, dtype=object),
                                          np.asarray(mv, dtype=object)), \
                        (what, mk, pv, mv)
        elif key.startswith('img'):
            assert port[key].dtype == ref[key].dtype
            assert np.array_equal(port[key], ref[key].transpose(2, 0, 1)), \
                (what, key)
        else:
            assert np.array_equal(port[key], ref[key]), (what, key)


@pytest.mark.parametrize('seed', range(4))
@pytest.mark.parametrize('wire', ['host', 'uint8'])
@pytest.mark.parametrize('name,scale', [('source_pipeline', (64, 64)),
                                        ('target_pipeline', (128, 128))])
def test_pipeline_matches_jax(tiles, name, scale, wire, seed):
    cfg = JaxConfig.fromfile(DATA_CFG)
    pipeline = _small(cfg[name], scale)
    if wire == 'uint8':
        for t in pipeline:
            if t['type'] == 'Normalize':
                t.update(type='DeferNormalize', wire_dtype='uint8')
    jax_pipeline = copy.deepcopy(pipeline)
    for t in jax_pipeline:
        if t['type'] == 'Resize':
            t['override_scale'] = True
    results = []
    for compose in (Compose(pipeline), JaxCompose(jax_pipeline)):
        np.random.seed(seed)
        results.append(compose(dict(
            img_info=dict(filename='t1.png', ann=dict(seg_map='t1.png')),
            ann_info=dict(seg_map='t1.png'),
            img_prefix=osp.join(tiles, 'img'),
            seg_prefix=osp.join(tiles, 'ann'), seg_fields=[])))
    _assert_same(*results, (name, wire, seed))


def test_eval_metrics_and_evaluate_match_jax(tiles):
    rs = np.random.RandomState(3)
    gts = [rs.randint(0, 7, (32, 40)) for _ in range(3)]
    gts[0][:4] = 255
    preds = [rs.randint(0, 6, (32, 40)) for _ in range(3)]
    for kw in (dict(), dict(reduce_zero_label=True),
               dict(label_map={1: 2}, reduce_zero_label=True)):
        got = eval_metrics(preds, gts, 6, 255, ['mIoU', 'mDice', 'mFscore'],
                           **kw)
        ref = jax_eval_metrics(preds, gts, 6, 255,
                               ['mIoU', 'mDice', 'mFscore'], **kw)
        assert got.keys() == ref.keys()
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k])
    ds_args = dict(pipeline=[], img_dir=osp.join(tiles, 'img'),
                   ann_dir=osp.join(tiles, 'ann'))
    port_ds, jax_ds = ISPRSDataset(**ds_args), JaxISPRS(**ds_args)
    preds = [rs.randint(0, 6, (128, 128)) for _ in range(2)]
    for results in ([preds, preds],
                    [port_ds.pre_eval(preds, [0, 1]),
                     jax_ds.pre_eval(preds, [0, 1])]):
        got = port_ds.evaluate(results[0], ['mIoU', 'mDice'], logger='silent')
        ref = jax_ds.evaluate(results[1], ['mIoU', 'mDice'], logger='silent')
        assert got == ref


class _Indices:
    def __len__(self):
        return 11

    def __getitem__(self, i):
        return {'idx': np.array(i)}


@pytest.mark.parametrize('position', [None, 0, 5, 9])
def test_loader_index_stream_matches_jax(position):
    streams = []
    for cls in (DataLoader, JaxDataLoader):
        loader = cls(_Indices(), samples_per_gpu=3, workers_per_gpu=2,
                     shuffle=True, seed=7, drop_last=True, infinite=True)
        if position is not None:
            loader.set_position(position)
        it = iter(loader)
        batches = [next(it) for _ in range(8)]
        it.close()
        if cls is DataLoader:
            loader.close()
            for b in batches:
                assert b['indices'].tolist() == b['idx'].tolist()
        streams.append([np.asarray(b['idx']).tolist() for b in batches])
    assert streams[0] == streams[1]
