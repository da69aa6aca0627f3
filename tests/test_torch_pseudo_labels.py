"""The port's two-phase pseudo-label workflow on the CPU, against the JAX
package.

One module fixture writes a small ISPRS-like tree (64x64 tiles), weights
for the tiny DeepLabV3+ of ``tests/test_pseudo_label_flow.py`` drawn by
``torch_parity.jax_variables`` and carried into the port, and runs both
generators once on the validation tiles with features saved: the JAX tool
(``tools/gen_pseudo_labels.py``, through h5py) and the port's
(``tools/gen_pseudo_labels_torch.py``, through its own HDF5 writer). Then:

* the port's HDF5 reader on h5py's files and h5py on the port's, bit for
  bit, and what the reader refuses;
* the port's corpus against the JAX tool's: logits within one float16 ulp
  of the stored value plus 1e-4, thresholds within one histogram bin
  (log C / 8192), sigmas within rtol 1e-4, the gaussian similarity maps
  within 2 float16 ulps;
* both packages' ``LoadAnnotationsPseudoLabelsV2`` on both corpora;
* ``compute_class_stats`` (byte-equal JSON files), ``get_rcs_class_probs``
  and the rare-class draws of ``UDADataset`` / ``UDADatasetV2`` under one
  ``np.random`` seed;
* ``similarity_histogram``'s counts;
* the hooks in ``train_segmentor``: ``PseudoLabelingHookV4`` halts the
  loop at its ``trigger_iter`` and leaves a corpus, and any other
  exception a hook raises propagates.
"""
import json
import os
import os.path as osp
import sys

import cv2
import h5py
import numpy as np
import pytest
import torch

# torch's OpenMP pool must not run beside XLA-CPU in one process
torch.set_num_threads(1)

import jax  # noqa: E402,F401

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, osp.join(REPO, 'tools'))

import compute_class_stats_torch  # noqa: E402
import gen_pseudo_labels  # noqa: E402
import gen_pseudo_labels_torch  # noqa: E402
import pack_dataset_torch  # noqa: E402
from torch_parity import (jax_variables, load_port, shared_by_workers,  # noqa: E402
                          shared_dir)

from pfst_tpu.core.checkpoint import save_checkpoint as save_orbax  # noqa: E402
from pfst_tpu.core.hooks.plot_statistics_hook import \
    similarity_histogram as jax_histogram  # noqa: E402
from pfst_tpu.core.hooks.rare_class_sampling_hook import \
    compute_class_stats as jax_class_stats  # noqa: E402
from pfst_tpu.datasets import build_dataset as jax_dataset  # noqa: E402
from pfst_tpu.datasets.pipelines.loading import \
    LoadAnnotationsPseudoLabelsV2 as JaxLoader  # noqa: E402
from pfst_tpu.datasets.uda_dataset import \
    get_rcs_class_probs as jax_rcs_probs  # noqa: E402
from pfst_tpu.models import build_segmentor as jax_segmentor  # noqa: E402
from pfst_tpu.utils import Config as JaxConfig  # noqa: E402
from pfst_tpu_torch.apis import init_segmentor, train_segmentor  # noqa: E402
from pfst_tpu_torch.core.hooks import (HOOKS, Hook, compute_class_stats,  # noqa: E402
                                       similarity_histogram)
from pfst_tpu_torch.datasets import build_dataset  # noqa: E402
from pfst_tpu_torch.datasets.pipelines import (  # noqa: E402
    Compose, LoadAnnotationsPseudoLabelsV2, UnsupportedH5, read_h5, write_h5)
from pfst_tpu_torch.datasets.uda_dataset import get_rcs_class_probs  # noqa: E402
from pfst_tpu_torch.utils import Config  # noqa: E402

HW, NUM_CLASSES, N_VAL, N_TRAIN = 64, 6, 3, 4
RATIOS = (0.01, 0.05, 0.1, 0.15, 0.2, 0.25, 0.3, 0.35, 0.4, 0.45, 0.5)
BIN = np.log(NUM_CLASSES) / 8192
GEN_ARGS = ['--split', 'val', '--save-feats', '--feat-levels', '3',
            '--mean-sim', '0.6']
CONFIG = """
norm_cfg = dict(type='BN', requires_grad=True)
model = dict(
    type='EncoderDecoder',
    backbone=dict(type='ResNetV1c', depth=18, num_stages=4,
                  base_channels=8, stem_channels=8,
                  out_indices=(0, 1, 2, 3), dilations=(1, 1, 2, 4),
                  strides=(1, 2, 1, 1), norm_cfg=norm_cfg,
                  contract_dilation=True),
    decode_head=dict(type='DepthwiseSeparableASPPHead', in_channels=64,
                     in_index=3, channels=16, dilations=(1, 6, 12, 18),
                     c1_in_channels=8, c1_channels=4, dropout_ratio=0.1,
                     num_classes=6, norm_cfg=norm_cfg,
                     align_corners=False,
                     loss_decode=dict(type='CrossEntropyLoss',
                                      use_sigmoid=False,
                                      loss_weight=1.0)),
    train_cfg=dict(),
    test_cfg=dict(mode='whole'))
img_norm = dict(mean=[123.675, 116.28, 103.53],
                std=[58.395, 57.12, 57.375], to_rgb=True)
test_pipeline = [
    dict(type='LoadImageFromFile'),
    dict(type='MultiScaleFlipAug', img_scale=({hw}, {hw}), flip=False,
         transforms=[
             dict(type='Resize', keep_ratio=True),
             dict(type='Normalize', **img_norm),
             dict(type='ImageToTensor', keys=['img']),
             dict(type='Collect', keys=['img']),
         ])
]
data = dict(
    samples_per_gpu=2, workers_per_gpu=0,
    train=dict(type='ISPRSDataset', data_root='{root}',
               img_dir='img_dir/train', ann_dir='ann_dir/train',
               pipeline=[
                   dict(type='LoadImageFromFile'),
                   dict(type='LoadAnnotations', reduce_zero_label=True),
                   dict(type='Normalize', **img_norm),
                   dict(type='DefaultFormatBundle'),
                   dict(type='Collect', keys=['img', 'gt_semantic_seg'])]),
    val=dict(type='ISPRSDataset', data_root='{root}',
             img_dir='img_dir/val', ann_dir='ann_dir/val',
             pipeline=test_pipeline),
    test=dict(type='ISPRSDataset', data_root='{root}',
              img_dir='img_dir/val', ann_dir='ann_dir/val',
              pipeline=test_pipeline))
optimizer = dict(type='AdamW', lr=1e-4, betas=(0.9, 0.999),
                 weight_decay=0.01)
optimizer_config = dict()
runner = dict(type='IterBasedRunner', max_iters=4)
log_config = dict(interval=1, hooks=[dict(type='TextLoggerHook')])
checkpoint_config = dict(interval=1)
evaluation = dict(interval=4, metric='mIoU')
"""


def _ulp16(a):
    return np.spacing(np.abs(np.asarray(a, np.float16))).astype(np.float32)


def _write_tree(root):
    rs = np.random.RandomState(0)
    for split, n in (('train', N_TRAIN), ('val', N_VAL)):
        os.makedirs(osp.join(root, 'img_dir', split))
        os.makedirs(osp.join(root, 'ann_dir', split))
        for i in range(n):
            img = rs.randint(0, 255, (HW, HW, 3), np.uint8)
            # classes 1..6 (reduce_zero_label) in blocks, class 6 rare
            ann = np.repeat(np.repeat(rs.randint(1, 6, (4, 4)), 16, 0), 16, 1)
            ann[:4 + 4 * i, :8] = 6
            cv2.imwrite(osp.join(root, 'img_dir', split, f'{split}{i}.png'),
                        img)
            cv2.imwrite(osp.join(root, 'ann_dir', split, f'{split}{i}.png'),
                        ann.astype(np.uint8))


def _make_corpus(root):
    data = osp.join(root, 'data')
    _write_tree(data)
    cfg_path = osp.join(root, 'cfg.py')
    with open(cfg_path, 'w') as f:
        f.write(CONFIG.replace('{root}', data).replace('{hw}', str(HW)))
    jcfg = JaxConfig.fromfile(cfg_path)
    model_cfg = dict(jcfg.model)
    model_cfg.pop('train_cfg')
    variables = jax_variables(jax_segmentor(model_cfg), (1, HW, HW, 3))
    jckpt = save_orbax(osp.join(root, 'jax'), 1, variables)
    port = load_port(init_segmentor(cfg_path, device='cpu'), variables)
    os.makedirs(osp.join(root, 'port'))
    pckpt = osp.join(root, 'port', 'iter_1.pth')
    torch.save({'state_dict': port.state_dict()}, pckpt)
    jdir, pdir = osp.join(root, 'jax_corpus'), osp.join(root, 'port_corpus')
    gen_pseudo_labels.main([cfg_path, jckpt, '--out-dir', jdir, *GEN_ARGS])
    summary = gen_pseudo_labels_torch.main(
        [cfg_path, pckpt, '--out-dir', pdir, *GEN_ARGS, '--device', 'cpu'])
    # the rare-class statistics the UDA datasets read from the source root
    compute_class_stats(build_dataset(_train_cfg(data, 'source')), data)
    return dict(root=root, data=data, cfg_path=cfg_path, jdir=jdir,
                pdir=pdir, pckpt=pckpt, summary=summary)


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    """The tree, both corpora and the class statistics, made once a
    test run (the JAX tool's jit is most of it) and read by every
    worker."""
    root = shared_dir(tmp_path_factory) / 'pseudo_labels'
    return shared_by_workers(tmp_path_factory, 'pseudo_labels_corpus',
                             lambda: _make_corpus(str(root)))


def _h5s(d):
    return sorted(f for f in os.listdir(d) if f.endswith('.h5'))


def _h5py_read(path):
    with h5py.File(path, 'r') as f:
        return {k: f[k][()] for k in f}


def _assert_bitwise(got, want):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and \
            got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k


def test_h5_reader_reads_the_jax_tools_files_bitwise(corpus):
    files = _h5s(corpus['jdir'])
    assert len(files) == N_VAL
    for name in files:
        path = osp.join(corpus['jdir'], name)
        _assert_bitwise(read_h5(path), _h5py_read(path))


def test_h5py_reads_the_ports_files_bitwise(corpus, tmp_path):
    for name in _h5s(corpus['pdir']):
        path = osp.join(corpus['pdir'], name)
        _assert_bitwise(_h5py_read(path), read_h5(path))
    # every dtype and byte order the writer takes, a scalar, an empty
    # array and names past one symbol-table node
    rs = np.random.RandomState(1)
    arrays = {f'a{i:02d}': rs.randn(3, 2).astype(dt) for i, dt in enumerate(
        ['<f2', '>f2', '<f4', '>f4', '<f8', '>f8', 'i1', 'u1', '<i2', '>u2',
         '<i4', '>i4', '<u8', '>i8'])}
    arrays.update(scalar=np.float32(2.5), empty=np.zeros((0, 3), np.int16))
    path = str(tmp_path / 'all.h5')
    write_h5(path, arrays)
    got = _h5py_read(path)
    assert sorted(got) == sorted(arrays)
    for k, v in arrays.items():
        assert got[k].dtype == v.dtype and got[k].tobytes() == \
            np.asarray(v).tobytes(), k
    _assert_bitwise(read_h5(path), got)


def test_h5_reader_follows_continuations_and_a_deep_btree(tmp_path):
    """A dataset whose header grew past its first block (attributes added
    after it was written, so a continuation message), and 300 datasets
    (a group B-tree of level 1 over 38 symbol-table nodes)."""
    path = str(tmp_path / 'deep.h5')
    with h5py.File(path, 'w') as f:
        f.create_dataset('x', data=np.arange(10.0))
        for i in range(300):
            f.create_dataset(f'd{i:03d}', data=np.full(2, i, np.int16))
    with h5py.File(path, 'a') as f:
        for i in range(40):
            f['x'].attrs[f'a{i}'] = np.arange(20)
        f.create_dataset('y', data=np.arange(3, dtype='>f4'))
    _assert_bitwise(read_h5(path), _h5py_read(path))
    assert read_h5(path, ['y', 'missing']).keys() == {'y'}


@pytest.mark.parametrize('case,match', [
    ('chunked', 'chunked layout'), ('gzip', 'filter pipeline'),
    ('group', 'nested group'), ('latest', 'superblock version 3'),
    ('string', 'datatype class 3')])
def test_h5_reader_refuses_what_it_does_not_read(tmp_path, case, match):
    path = str(tmp_path / f'{case}.h5')
    with h5py.File(path, 'w', libver='latest' if case == 'latest'
                   else 'earliest') as f:
        if case == 'group':
            f.create_group('sub').create_dataset('x', data=np.ones(3))
        elif case == 'string':
            f.create_dataset('x', data=np.array([b'ab']))
        else:
            f.create_dataset('x', data=np.arange(100.0), chunks=(10,),
                             compression='gzip' if case == 'gzip' else None)
    with pytest.raises(UnsupportedH5, match=match):
        read_h5(path)


def _same_neighbourhoods(a, b, k=3, d=2):
    """(h, w, k*k) mask: True where the (h, w, C) maps ``a`` and ``b``
    hold equal features at the pixel and at its q-th neighbour (or the
    neighbour lies outside the map)."""
    eq = (a == b).all(-1)
    pad = (k // 2) * d
    eqp = np.pad(eq, pad, constant_values=True)
    h, w = eq.shape
    return np.stack([eq & eqp[i * d:i * d + h, j * d:j * d + w]
                     for i in range(k) for j in range(k)], -1)


def test_generator_matches_the_jax_tool(corpus):
    jdir, pdir = corpus['jdir'], corpus['pdir']
    sigmas = {}
    for d in (jdir, pdir):
        with open(osp.join(d, 'sigmas.json')) as f:
            sigmas[d] = json.load(f)
    assert sigmas[jdir].keys() == sigmas[pdir].keys() == {'0.6'}
    np.testing.assert_allclose(sigmas[pdir]['0.6'], sigmas[jdir]['0.6'],
                               rtol=1e-4)
    sigmas = sigmas[pdir]
    assert _h5s(jdir) == _h5s(pdir) == [f'val{i}.h5' for i in range(N_VAL)]
    for name in _h5s(jdir):
        want, got = read_h5(osp.join(jdir, name)), read_h5(osp.join(pdir, name))
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and \
                got[k].shape == want[k].shape, k
        assert got['seg_logits'].shape == (NUM_CLASSES, HW, HW)
        assert got['feats_3'].shape == (HW // 8, HW // 8, 64)
        assert got['gaussian_sim_feat_3'].shape == (HW // 8, HW // 8, 9)
        for k in ('seg_logits', 'feats_3'):
            err = np.abs(got[k].astype(np.float32) - want[k])
            assert (err <= _ulp16(want[k]) + 1e-4).all(), (k, err.max())
        for r in RATIOS:
            w, g = want[f'thre@{r}'], got[f'thre@{r}']
            np.testing.assert_array_equal(np.isinf(g), np.isinf(w))
            fin = np.isfinite(w)
            assert (np.abs(g[fin] - w[fin]) <= BIN * (1 + 1e-5)).all(), r
        # the similarity maps within 2 float16 ulps wherever both corpora
        # stored the same features for a pixel and its neighbour (a
        # feature one ulp apart moves a map value by up to ~3 ulps); and
        # the port's map against the JAX tool's function of the port's own
        # stored features and sigma, everywhere
        sim_w, sim_g = want['gaussian_sim_feat_3'], got['gaussian_sim_feat_3']
        err = np.abs(sim_g.astype(np.float32) - sim_w)
        same = _same_neighbourhoods(want['feats_3'], got['feats_3'])
        assert same.mean() > 0.5
        assert (err <= 2 * _ulp16(sim_w))[same].all(), err[same].max()
        ref = gen_pseudo_labels.gaussian_sim_map(
            got['feats_3'].astype(np.float32), 3, 2,
            sigmas['0.6']).astype(np.float16)
        err = np.abs(sim_g.astype(np.float32) - ref)
        assert (err <= 2 * _ulp16(ref)).all(), err.max()
    times = corpus['summary']['times']
    assert all(len(times[k]) == N_VAL for k in times)


def _loader_input(name, hw=(HW, HW)):
    return dict(img=np.zeros(hw + (3,), np.uint8), filename=f'/x/{name}.png',
                img_info=dict(filename=f'{name}.png'), ann_info={},
                seg_fields=[])


@pytest.mark.parametrize('source', ['jax_corpus', 'port_corpus'])
@pytest.mark.parametrize('ratio,hw', [(0.1, (HW, HW)), (0.0, (HW, HW)),
                                      (0.5, (48, 80))])
def test_loaders_agree_on_one_corpus(corpus, source, ratio, hw):
    """Both packages' loaders on the JAX tool's corpus and on the port's:
    equal labels and sim maps; ``pseudo_ratio=0.0`` (no such threshold
    key) keeps every pixel; a label of another size than the image is
    resized by nearest neighbour."""
    d = osp.join(corpus['root'], source)
    kwargs = dict(pseudo_labels_dir=d, pseudo_ratio=ratio, load_feats=True,
                  sim_feat_names=('gaussian_sim_feat_3',))
    for i in range(N_VAL):
        want = JaxLoader(**kwargs)(_loader_input(f'val{i}', hw))
        got = LoadAnnotationsPseudoLabelsV2(**kwargs)(
            _loader_input(f'val{i}', hw))
        assert got['gt_semantic_seg'].dtype == np.uint8
        assert got['gt_semantic_seg'].shape == hw
        np.testing.assert_array_equal(got['gt_semantic_seg'],
                                      want['gt_semantic_seg'])
        np.testing.assert_array_equal(got['gaussian_sim_feat_3'],
                                      want['gaussian_sim_feat_3'])
        assert got['gaussian_sim_feat_3'].dtype == np.float32
        kept = got['gt_semantic_seg'] != 255
        if ratio == 0.0:
            assert kept.all()
        else:
            assert 0 < kept.mean() < 1


def test_loader_finds_the_corpus_for_a_packed_image(corpus, tmp_path):
    """The file is looked up by the image's basename, also when the image
    is read from a pack (``tools/pack_dataset_torch.py``)."""
    import shutil
    data = str(tmp_path / 'data')
    shutil.copytree(corpus['data'], data)
    assert pack_dataset_torch.main([data, '--recursive']) > 0
    ds = build_dataset(dict(
        type='ISPRSDataset', data_root=data, img_dir='img_dir/val',
        ann_dir='ann_dir/val', pipeline=[
            dict(type='LoadImageFromFile'),
            dict(type='LoadAnnotationsPseudoLabelsV2',
                 pseudo_labels_dir=corpus['pdir'], pseudo_ratio=0.2),
            dict(type='DefaultFormatBundle'),
            dict(type='Collect', keys=['img', 'gt_semantic_seg'])]))
    loader = LoadAnnotationsPseudoLabelsV2(pseudo_labels_dir=corpus['pdir'],
                                           pseudo_ratio=0.2)
    for i in range(N_VAL):
        want = loader(_loader_input(f'val{i}'))['gt_semantic_seg']
        np.testing.assert_array_equal(ds[i]['gt_semantic_seg'], want)


def _train_cfg(data, flavour):
    return dict(type='ISPRSDataset', data_root=data,
                img_dir='img_dir/train', ann_dir='ann_dir/train',
                pipeline=[dict(type='LoadImageFromFile'),
                          dict(type='LoadAnnotations',
                               reduce_zero_label=True),
                          dict(type='DefaultFormatBundle'),
                          dict(type='Collect',
                               keys=['img', 'gt_semantic_seg'])]) \
        if flavour == 'source' else dict(
            type='ISPRSDataset', data_root=data,
            img_dir='img_dir/val', ann_dir='ann_dir/val',
            pipeline=[dict(type='LoadImageFromFile'),
                      dict(type='DefaultFormatBundle'),
                      dict(type='Collect', keys=['img'])])


def test_class_stats_and_rcs_probs_match_jax(corpus, tmp_path):
    """``compute_class_stats``' two files byte-equal to the JAX function's
    (the port's through ``tools/compute_class_stats_torch.py``), and
    ``get_rcs_class_probs`` equal."""
    src = _train_cfg(corpus['data'], 'source')
    jout, pout = tmp_path / 'jax', tmp_path / 'port'
    jout.mkdir()
    pout.mkdir()
    jax_class_stats(jax_dataset(src), str(jout))
    compute_class_stats_torch.main([corpus['cfg_path'], '--split', 'train',
                                    '--branch', 'flat', '-o', str(pout)])
    for name in ('sample_class_stats.json', 'samples_with_class.json'):
        assert (pout / name).read_bytes() == (jout / name).read_bytes(), name
    classes, prob = get_rcs_class_probs(str(pout), 0.01)
    want_classes, want_prob = jax_rcs_probs(str(jout), 0.01)
    assert classes == want_classes and len(classes) == NUM_CLASSES
    np.testing.assert_array_equal(prob, want_prob)
    assert classes[0] == 5      # the rare class drawn most often


@pytest.mark.parametrize('kind', ['UDADataset', 'UDADatasetV2'])
def test_rare_class_draws_match_jax(corpus, monkeypatch, kind):
    """Under one ``np.random`` seed both packages' UDA datasets with
    rare-class sampling draw the same (class, file, target index)
    sequence (``min_crop_ratio`` 0: no re-crop draws), on the statistics
    the fixture wrote into the source's root."""
    cfg = dict(type=kind, source=_train_cfg(corpus['data'], 'source'),
               target=_train_cfg(corpus['data'], 'target'),
               rare_class_sampling=dict(class_temp=0.1, min_crop_ratio=0.0,
                                        min_pixels=100))
    draws = {}
    choice = np.random.choice
    for name, build in (('jax', jax_dataset), ('port', build_dataset)):
        ds = build(cfg)
        seen = []

        def record(*args, **kwargs):
            seen.append(choice(*args, **kwargs))
            return seen[-1]

        monkeypatch.setattr(np.random, 'choice', record)
        np.random.seed(3)
        files = [(s['img_metas']['filename'], s['target_img_metas']['filename'])
                 for s in (ds[i] for i in range(8))]
        monkeypatch.setattr(np.random, 'choice', choice)
        draws[name] = ([str(v) for v in seen], files)
    assert len(draws['port'][0]) == 3 * 8
    assert draws['port'] == draws['jax']
    assert len(set(draws['port'][0][0::3])) > 1


@pytest.mark.parametrize('sigma', [None, 5.0])
def test_similarity_histogram_matches_jax(sigma):
    """Counts equal to the JAX hook's on features whose similarities lie
    away from the bin edges, but for two kinds that sit on one by
    construction: the exact zeros of zero-padded cosine neighbours (the
    same in both) and the centre tap's self-similarity, 1 for gaussian
    and within an ulp of 1 for cosine, where a value an ulp above 1 falls
    out of the range: so for cosine the last bin may differ by up to the
    number of centre taps."""
    x = np.random.RandomState(5).randn(2, 12, 12, 16).astype(np.float32)
    want, want_edges = jax_histogram(x, 3, 2, sigma)
    got, edges = similarity_histogram(
        torch.from_numpy(x.transpose(0, 3, 1, 2).copy()), 3, 2, sigma)
    np.testing.assert_array_equal(edges, want_edges)
    from pfst_tpu_torch.ops import torch_neighborhood_similarity
    vals = torch_neighborhood_similarity(
        torch.from_numpy(x.transpose(0, 3, 1, 2).copy()), 3, 2,
        'cosine' if sigma is None else 'gaussian',
        30.0 if sigma is None else sigma).numpy()
    vals = np.delete(vals, 4, axis=1).reshape(-1)
    vals = vals[vals != 0]
    gap = np.abs(vals[:, None] - edges[None]).min()
    assert gap > 1e-6
    if sigma is None:
        np.testing.assert_array_equal(got[:-1], want[:-1])
        assert abs(int(got[-1]) - int(want[-1])) <= 2 * 12 * 12
    else:
        np.testing.assert_array_equal(got, want)
    assert got.sum() >= 2 * 12 * 12 * 8


def _loop_cfg(corpus, custom_hooks):
    cfg = Config.fromfile(corpus['cfg_path'])
    cfg['custom_hooks'] = custom_hooks
    return cfg


def test_pseudo_labeling_hook_halts_the_loop(corpus, tmp_path):
    """``PseudoLabelingHookV4`` at ``trigger_iter`` 2 labels the
    validation split from the latest checkpoint (iteration 1's: hooks run
    before their iteration's checkpoint), then halts the loop there; the
    halted state is checkpointed. Beside it: ``RareClassSamplingHook``
    writes its statistics before the run, ``PlotStatisticsHook`` returns
    at once after the eval (the loop gives it no ``val_loader``), and an
    unregistered hook type is skipped."""
    out = str(tmp_path / 'corpus')
    stats = tmp_path / 'stats'
    stats.mkdir()
    cfg = _loop_cfg(corpus, [
        dict(type='RareClassSamplingHook', out_dir=str(stats)),
        dict(type='PlotStatisticsHook', log_dir=str(tmp_path / 'plots')),
        dict(type='NoSuchHook'),
        dict(type='PseudoLabelingHookV4', out_dir=out, split='val',
             trigger_iter=2)])
    cfg.merge_from_dict({'evaluation.interval': 1})
    hist = []
    work = str(tmp_path / 'work')
    train_segmentor(cfg, work_dir=work, device='cpu', history=hist)
    assert [h['iter'] for h in hist if h['kind'] == 'batch'] == [1, 2]
    assert [h['iter'] for h in hist if h['kind'] == 'halt'] == [2]
    assert [h['iter'] for h in hist if h['kind'] == 'eval'] == [1]
    assert sorted(os.listdir(work)) == ['iter_1.pth', 'iter_2.pth',
                                        'train.log']
    assert _h5s(out) == [f'val{i}.h5' for i in range(N_VAL)]
    stored = read_h5(osp.join(out, 'val0.h5'))
    assert sorted(stored) == sorted(['seg_logits'] + [f'thre@{r}'
                                                      for r in RATIOS])
    assert osp.isfile(osp.join(out, 'sigmas.json'))
    assert sorted(os.listdir(stats)) == ['sample_class_stats.json',
                                         'samples_with_class.json']
    assert not (tmp_path / 'plots').exists()


def test_other_hook_exceptions_propagate(corpus, tmp_path):
    """The JAX loop halts on any ValueError a hook raises; the port halts
    only on the pseudo-labelling hooks' ``_StopTraining``."""

    class RaisingHook(Hook):
        def after_train_iter(self, ctx, log_vars, vis_states=None):
            raise ValueError(f'hook failed at {ctx["iter"]}')

    HOOKS.register_module(name='RaisingHook', module=RaisingHook,
                          force=True)
    try:
        cfg = _loop_cfg(corpus, [dict(type='RaisingHook')])
        with pytest.raises(ValueError, match='hook failed at 1'):
            train_segmentor(cfg, work_dir=str(tmp_path / 'w'), device='cpu')
    finally:
        HOOKS.module_dict.pop('RaisingHook')


def test_pipeline_with_pseudo_labels_builds_from_a_config(corpus):
    """The loader as a config names it, in a ``Compose``."""
    pipe = Compose([dict(type='LoadAnnotationsPseudoLabels',
                         pseudo_labels_dir=corpus['jdir'],
                         pseudo_ratio=0.3)])
    res = pipe(_loader_input('val1'))
    want = JaxLoader(pseudo_labels_dir=corpus['jdir'], pseudo_ratio=0.3)(
        _loader_input('val1'))
    np.testing.assert_array_equal(res['gt_semantic_seg'],
                                  want['gt_semantic_seg'])
