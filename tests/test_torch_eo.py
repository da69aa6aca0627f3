"""The port's Inria and SeasonNet data path against cv2 and the JAX
package, on the same files and seeds.

* ``read_tiff`` equals ``cv2.imread`` bit for bit on TIFFs that cv2
  writes (120x120 tiles, which cv2 stores in several strips with a short
  last one: 11 rows a strip for 16-bit RGB, 68 for an 8-bit label):
  uint8 and uint16, 1 and 3 channels, LZW with the horizontal predictor
  (cv2's default), none and deflate, read 'color', 'unchanged' and
  'grayscale'; and on big-endian and tiled files that ``write_tiff``
  writes and cv2 reads (128x96, whose tiles cover the image: cv2 reads
  the partial edge tiles of a 16-bit grayscale file as zeros, so those
  are not compared). A planted control, 16-bit colour reduced by
  ``x >> 8`` instead of libtiff's rounding, must differ. ``imread``
  dispatches on the magic bytes, not the extension.
* ``imresize`` of float32 images equals ``cv2.resize`` (INTER_LINEAR)
  bit for bit at SeasonNet's test view (120x120 -> 128x128) and other
  sizes of two or more rows and columns.
* ``ClipNormalize`` and ``Uint82Float`` equal the JAX transforms exactly.
* ``EODataset`` / ``InriaDataset`` / ``SeasonNetDataset`` and the
  ``UDADataset`` / ``UDADatasetV2`` pairings of both leaf configs equal
  the JAX package's on the same synthetic trees and ``np.random`` seeds:
  length, CLASSES, PALETTE, record order, ``get_gt_seg_map_by_idx``, and
  every sample of the source, target and test pipelines (the port's
  images are CHW). The JAX ``Resize`` runs with ``override_scale=True``
  (ROADMAP C2), the Inria pipelines at 128x128 tiles and 64x64 crops. The
  SeasonNet crops are as small as 60x60; at widths that are not multiples
  of 32 cv2's HSV round trip disagrees with itself on a row's last pixels
  (``tests/test_native_hostaug.py``), so there the JAX side runs its own
  copy of the kernel the port uses (``PFST_NATIVE_HSV=1``).
* ``_img_norm_from_pipeline`` takes the SeasonNet config's ClipNormalize,
  as JAX's does.
* All four shipped leaf configs build in the port on tiny trees
  (``build_train_model`` on the CPU at the tiny widths) and give a batch.
"""
import copy
import os.path as osp
import sys

import numpy as np
import pytest
import torch

# torch's OpenMP pool must not run beside XLA-CPU in one process
torch.set_num_threads(1)

import cv2  # noqa: E402

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, osp.join(REPO, 'tools'))

import make_synthetic_data_torch  # noqa: E402
from conftest import tiny_model_cfg  # noqa: E402

from pfst_tpu.apis.train import (  # noqa: E402
    _img_norm_from_pipeline as jax_img_norm,
    apply_device_normalize as jax_device_normalize)
from pfst_tpu.datasets import build_dataset as jax_build_dataset  # noqa: E402
from pfst_tpu.datasets.pipelines import packing as jax_packing  # noqa: E402
from pfst_tpu.datasets.pipelines import transforms as jax_transforms  # noqa: E402
from pfst_tpu.utils import Config as JaxConfig  # noqa: E402
from pfst_tpu_torch.apis.train import (_img_norm_from_pipeline,  # noqa: E402
                                       apply_device_normalize)
from pfst_tpu_torch.datasets import build_dataloader, build_dataset  # noqa: E402
from pfst_tpu_torch.datasets.pipelines import (ClipNormalize,  # noqa: E402
                                               Uint82Float, imread, packing)
from pfst_tpu_torch.datasets.pipelines.tiff import (read_tiff,  # noqa: E402
                                                    write_tiff)
from pfst_tpu_torch.datasets.pipelines.transforms import imresize  # noqa: E402
from pfst_tpu_torch.models import build_train_model  # noqa: E402
from pfst_tpu_torch.utils import Config  # noqa: E402

PFST = osp.join(REPO, 'configs', 'pfst')
CONFIGS = {
    'inria': osp.join(PFST, 'pfst_inria_da_deeplabv3plus_r50-d8.py'),
    'season_net': osp.join(PFST,
                           'pfst_season_net_sp2fa_deeplabv3plus_r50-d8.py'),
    'pots2vaih': osp.join(PFST,
                          'pfst_pots_irrg2vaih_irrg_deeplabv3plus_r50-d8.py'),
    'vaih2pots': osp.join(PFST,
                          'pfst_vaih_irrg2pots_irrg_deeplabv3plus_r50-d8.py'),
}
MODES = {'color': cv2.IMREAD_COLOR, 'unchanged': cv2.IMREAD_UNCHANGED,
         'grayscale': cv2.IMREAD_GRAYSCALE}
CV2_COMPRESSION = {'lzw': None, 'none': 1, 'deflate': 8}


def _tile(rs, dtype, channels, shape=(120, 120)):
    high = 4000 if dtype == np.uint16 else 256
    return rs.randint(0, high, shape + ((channels,) if channels > 1
                                        else ())).astype(dtype)


def _same_as_cv2(path):
    for mode, flag in MODES.items():
        ref = cv2.imread(path, flag)
        got = read_tiff(path, mode)
        assert got.dtype == ref.dtype and got.shape == ref.shape, mode
        assert np.array_equal(got, ref), (path, mode)


@pytest.mark.parametrize('compression', sorted(CV2_COMPRESSION))
@pytest.mark.parametrize('channels', [1, 3])
@pytest.mark.parametrize('dtype', [np.uint8, np.uint16])
def test_read_tiff_matches_cv2(tmp_path, dtype, channels, compression):
    rs = np.random.RandomState(channels)
    path = str(tmp_path / 't.tif')
    flag = CV2_COMPRESSION[compression]
    cv2.imwrite(path, _tile(rs, dtype, channels),
                [] if flag is None else [cv2.IMWRITE_TIFF_COMPRESSION, flag])
    _same_as_cv2(path)


@pytest.mark.parametrize('channels', [1, 3, 4])
def test_big_endian_and_tiled_tiffs_read_as_cv2_reads_them(tmp_path,
                                                           channels):
    rs = np.random.RandomState(10 + channels)
    for dtype in (np.uint8, np.uint16):
        img = _tile(rs, dtype, channels, (96, 128))
        if dtype == np.uint16:
            img = img * 16
        for kw in (dict(big_endian=True), dict(tile=32),
                   dict(big_endian=True, tile=16, compression='deflate'),
                   dict(compression='packbits'),
                   dict(tile=32, compression='none')):
            path = str(tmp_path / 'w.tif')
            write_tiff(path, img, **kw)
            assert np.array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED),
                                  img), kw
            _same_as_cv2(path)


def test_write_tiff_reads_back_in_cv2_and_planted_control(tmp_path):
    rs = np.random.RandomState(3)
    for dtype in (np.uint8, np.uint16):
        for channels in (1, 3, 4):
            img = _tile(rs, dtype, channels)
            path = str(tmp_path / 'w.tif')
            write_tiff(path, img)
            assert np.array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED),
                                  img), (dtype, channels)
    # the planted control: a 16-bit RGB file reduced by its high byte
    img = _tile(rs, np.uint16, 3)
    path = str(tmp_path / 'c.tif')
    cv2.imwrite(path, img)
    shifted = (read_tiff(path, 'unchanged') >> 8).astype(np.uint8)
    assert not np.array_equal(shifted, cv2.imread(path, cv2.IMREAD_COLOR))
    assert np.array_equal(read_tiff(path, 'color'),
                          cv2.imread(path, cv2.IMREAD_COLOR))


def test_imread_dispatches_on_magic_bytes_and_packs_tiffs(tmp_path):
    rs = np.random.RandomState(4)
    img16, img8 = _tile(rs, np.uint16, 3), _tile(rs, np.uint8, 1)
    cv2.imwrite(str(tmp_path / 'a.tif'), img16)
    cv2.imwrite(str(tmp_path / 'b.tif'), img8)
    # a PNG and a TIFF under each other's extension
    cv2.imwrite(str(tmp_path / 'c.png'), img16[..., 0].astype(np.uint8))
    (tmp_path / 'd.tif').write_bytes((tmp_path / 'c.png').read_bytes())
    (tmp_path / 'e.png').write_bytes((tmp_path / 'b.tif').read_bytes())
    for name in ('a.tif', 'b.tif', 'd.tif', 'e.png'):
        path = str(tmp_path / name)
        assert np.array_equal(imread(path), cv2.imread(path)), name
        assert np.array_equal(imread(path, unchanged=True),
                              cv2.imread(path, cv2.IMREAD_UNCHANGED)), name
    assert packing.pack_directory(str(tmp_path)) == 5
    packing.invalidate()
    jax_packing.invalidate()
    for name in ('a.tif', 'b.tif'):
        path = str(tmp_path / name)
        for color, unchanged in ((True, False), (False, False),
                                 (True, True)):
            got = packing.lookup(path, color, unchanged)
            ref = jax_packing.lookup(path, color, unchanged)
            assert (got is None) == (ref is None), (name, color, unchanged)
            if ref is not None:
                assert np.array_equal(got, ref)


@pytest.mark.parametrize('src,dst', [((120, 120, 3), (128, 128)),
                                     ((120, 120, 3), (200, 77)),
                                     ((64, 64, 3), (100, 100)),
                                     ((97, 61, 3), (45, 23)),
                                     ((33, 50), (128, 128))])
def test_float32_bilinear_resize_matches_cv2(src, dst):
    img = (np.random.RandomState(5).rand(*src) * 255).astype(np.float32)
    ref = cv2.resize(img, dst, interpolation=cv2.INTER_LINEAR)
    got = imresize(img, dst)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)


def test_clip_normalize_and_uint8_to_float_match_jax():
    cfg = Config.fromfile(CONFIGS['season_net'])
    norm = dict(cfg.img_norm_cfg)
    rs = np.random.RandomState(6)
    for img in (rs.randint(0, 256, (20, 30, 3)).astype(np.uint8),
                rs.randint(0, 4000, (20, 30, 3)).astype(np.uint16)):
        for kw in (norm, dict(norm, to_rgb=False, to_uint8=False)):
            results = []
            for clip, to_float in (
                    (ClipNormalize, Uint82Float),
                    (jax_transforms.ClipNormalize,
                     jax_transforms.Uint82Float)):
                r = clip(**kw)(dict(img=img.copy(), img_fields=['img']))
                results.append(to_float()(r))
            got, ref = results
            assert got['img'].dtype == ref['img'].dtype == np.float32
            assert np.array_equal(got['img'], ref['img'])
            assert got['img_norm_cfg'].keys() == ref['img_norm_cfg'].keys()
            for k, v in ref['img_norm_cfg'].items():
                assert np.array_equal(got['img_norm_cfg'][k], v)


@pytest.fixture(scope='module')
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp('eo')
    tool = make_synthetic_data_torch.main
    tool(['-o', str(root / 'inria'), '--layout', 'inria', '--size', '128',
          '--num-train', '1', '--num-val', '1'])
    tool(['-o', str(root / 'season_net'), '--layout', 'season_net',
          '--size', '120', '--num-train', '2', '--num-val', '2'])
    for name, seed in (('pots', 0), ('vaih', 1)):
        tool(['-o', str(root / name), '--size', '64', '--num-train', '2',
              '--num-val', '1', '--seed', str(seed)])
    return root


def _rooted(cfg, name, root):
    """Point a config's datasets at the synthetic trees; the Inria
    pipelines at 128x128 tiles and 64x64 crops."""
    data = cfg.data
    if name in ('inria', 'season_net'):
        for node in (data.train.source, data.train.target, data.val,
                     data.test):
            node['data_root'] = str(root / name)
    else:
        src, trg = ('pots', 'vaih') if name == 'pots2vaih' else \
            ('vaih', 'pots')
        data.train.source['data_root'] = str(root / src)
        for node in (data.train.target, data.val, data.test):
            node['data_root'] = str(root / trg)
    if name == 'inria':
        for node in (data.train.source, data.train.target):
            for t in node.pipeline:
                if t['type'] == 'Resize':
                    t['img_scale'] = (128, 128)
                if t['type'] in ('RandomCrop', 'Pad'):
                    t['crop_size' if t['type'] == 'RandomCrop'
                      else 'size'] = (64, 64)
    return cfg


def _jax_resize_draws(node):
    for t in node['pipeline']:
        if t['type'] == 'Resize':
            t['override_scale'] = True


def _same_metas(meta, ref_meta, what):
    assert meta.keys() == ref_meta.keys(), what
    for k, v in ref_meta.items():
        if isinstance(v, dict):
            assert {a: np.asarray(b).tolist() for a, b in meta[k].items()} \
                == {a: np.asarray(b).tolist() for a, b in v.items()}, what
        else:
            assert np.array_equal(np.asarray(meta[k], dtype=object),
                                  np.asarray(v, dtype=object)), (what, k)


def _same_image(img, ref, what):
    """Equal dtype and values; the port's image is CHW, JAX's HWC."""
    assert img.dtype == ref.dtype, what
    assert np.array_equal(img, ref.transpose(2, 0, 1)), what


def _same_sample(port, ref, what):
    """A train sample (images, label map, metas) or a test sample (lists
    of views and metas)."""
    assert port.keys() == ref.keys(), what
    for key, value in ref.items():
        if key.endswith('img_metas'):
            metas = zip(port[key], value) if isinstance(value, list) \
                else [(port[key], value)]
            for m, r in metas:
                _same_metas(m, r, (what, key))
        elif isinstance(value, list):
            for img, r in zip(port[key], value):
                _same_image(img, r, (what, key))
        elif 'img' in key:
            _same_image(port[key], value, (what, key))
        else:
            assert np.array_equal(port[key], value), (what, key)


@pytest.mark.parametrize('name', ['inria', 'season_net'])
def test_eo_datasets_match_jax(trees, monkeypatch, name):
    if name == 'season_net':
        monkeypatch.setenv('PFST_NATIVE_HSV', '1')
    cfg = apply_device_normalize(_rooted(Config.fromfile(CONFIGS[name]),
                                         name, trees))
    jcfg = jax_device_normalize(_rooted(JaxConfig.fromfile(CONFIGS[name]),
                                        name, trees))
    for node in (jcfg.data.train.source, jcfg.data.train.target):
        _jax_resize_draws(node)
    port, ref = build_dataset(cfg.data.train), \
        jax_build_dataset(jcfg.data.train)
    assert type(port).__name__ == type(ref).__name__
    assert len(port) == len(ref) > 0
    for side in ('source', 'target'):
        p, r = getattr(port, side), getattr(ref, side)
        assert type(p).__name__ == type(r).__name__
        assert p.img_infos == r.img_infos and len(p) > 0
        assert tuple(p.CLASSES) == tuple(r.CLASSES)
        assert p.PALETTE == r.PALETTE
    for i in range(len(port)):
        for seed in range(2):
            np.random.seed(seed)
            got = port[i]
            np.random.seed(seed)
            _same_sample(got, ref[i], (name, i, seed))
    for split in ('val', 'test'):
        p = build_dataset({**cfg.data[split], 'test_mode': True})
        r = jax_build_dataset({**jcfg.data[split], 'test_mode': True})
        assert p.img_infos == r.img_infos and len(p) > 0
        assert (tuple(p.CLASSES), p.PALETTE) == (tuple(r.CLASSES), r.PALETTE)
        for i in range(len(p)):
            assert np.array_equal(p.get_gt_seg_map_by_idx(i),
                                  r.get_gt_seg_map_by_idx(i))
            _same_sample(p[i], r[i], (name, split, i))


def test_img_norm_takes_clip_normalize_as_jax_does():
    for path in CONFIGS.values():
        cfg = Config.fromfile(path)
        got = _img_norm_from_pipeline(cfg)
        assert got == jax_img_norm(JaxConfig.fromfile(path)), path
    season = Config.fromfile(CONFIGS['season_net'])
    assert _img_norm_from_pipeline(season)['mean'] == \
        season.img_norm_cfg['mean']


@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_leaf_configs_build_and_give_a_batch(trees, name):
    cfg = _rooted(Config.fromfile(CONFIGS[name]), name, trees)
    cfg.model = tiny_model_cfg(cfg.model.decode_head.num_classes)
    cfg.data.workers_per_gpu = 1
    apply_device_normalize(cfg)
    algo = build_train_model(copy.deepcopy(cfg), device='cpu')
    assert algo.num_classes == len(build_dataset(cfg.data.val).CLASSES)
    dataset = build_dataset(cfg.data.train)
    batch_size = min(cfg.data.samples_per_gpu, len(dataset))
    loader = build_dataloader(dataset, batch_size, 1, shuffle=True, seed=0,
                              drop_last=True, infinite=True)
    it = iter(loader)
    try:
        batch = next(it)
    finally:
        it.close()
        loader.close()
    for key in ('img', 'target_img', 'gt_semantic_seg'):
        assert batch[key].shape[0] == batch_size, key
    assert batch['img'].shape[1] == 3
