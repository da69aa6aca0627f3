"""The port's spatially sharded inference (``pfst_tpu_torch/parallel/
spatial.py``) against the JAX functions on virtual devices and the port's
whole-scene forward, on the CPU.

Four gloo ranks of the port (``tests/torch_dist_worker.py``, started once
a module, every join and collective limited to 120 s) run the tiny
DeepLabV3+ of ``tests/test_spatial.py`` (``conftest.tiny_model_cfg``:
ResNetV1c-18, 8 wide, ASPP dilations 6, 12, 18) in eval mode with its
running statistics away from their init:

* ``spatial_inference`` of a 128 x 64 scene over 2 ranks (stripes of 64
  rows) and over 4 (32 rows: at 1/8 a stripe is 4 rows, and ASPP's
  dilation 18 reads rows of the neighbour's neighbours), and on a 2 x 2
  grid (the diagonal neighbours' corners), against JAX's
  ``spatial_inference`` on 2 and 4 virtual devices and ``grid=(2, 2)``,
  and against the port's whole forward;
* ``make_spatial_inference_fn`` at heights that do not divide (67 over 2
  ranks, 130 over 4): edge-padded, the padded rows in the image pool,
  cropped back, against the JAX function of ``pfst_tpu/apis/test.py``;
* ``single_gpu_test(spatial=2)`` on 5 images, against ``single_gpu_test``,
  and ``tools/test_torch.py --spatial 2`` on the tiny leaf config, its
  mIoU against ``single_gpu_test``'s.

Logits atol 1e-5 (the JAX tests' bound) against JAX; against the port's
own whole forward the blocks add in another order only in the image
pool's sum, atol 1e-6.
"""
import os.path as osp
import sys

import numpy as np
import pytest
import torch

# torch's OpenMP pool must not run beside XLA-CPU in one process
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from conftest import tiny_model_cfg  # noqa: E402
from test_torch_loop import tiny_config  # noqa: E402
from torch_dist_worker import (ToyDataset, ToyLoader, join_ranks,  # noqa: E402
                               start_ranks)
from torch_parity import (jax_variables, load_port, nchw,  # noqa: E402
                          shared_by_workers, shared_dir)

from pfst_tpu.apis.test import make_spatial_inference_fn as jax_padded  # noqa: E402
from pfst_tpu.models import build_segmentor as jax_segmentor  # noqa: E402
from pfst_tpu.parallel import spatial as jax_spatial  # noqa: E402
from pfst_tpu_torch.apis import init_segmentor, single_gpu_test  # noqa: E402
from pfst_tpu_torch.datasets import build_dataloader, build_dataset  # noqa: E402
from pfst_tpu_torch.models import build_segmentor  # noqa: E402
from pfst_tpu_torch.parallel.spatial import Grid, scatter_scene  # noqa: E402
from pfst_tpu_torch.utils import Config  # noqa: E402

sys.path.insert(0, osp.join(osp.dirname(__file__), '..', 'tools'))
import make_synthetic_data_torch  # noqa: E402
import pack_dataset_torch  # noqa: E402

WORLD = 4
TOL = dict(rtol=1e-5, atol=1e-5)
# (name, ranks, grid, (h, w), padded)
CASES = [('two', 2, None, (128, 64), False),
         ('four', 4, None, (128, 64), False),
         ('grid', 4, (2, 2), (128, 64), False),
         ('pad_two', 2, None, (67, 64), True),
         ('pad_four', 4, None, (130, 64), True)]


def _scene(hw, seed):
    return np.random.RandomState(seed).randn(1, *hw, 3).astype(np.float32)


def _jax_logits(jmodel, variables, name, ranks, grid, scene, padded):
    if padded:
        return np.asarray(jax_padded(jmodel, ranks)(variables,
                                                    jnp.asarray(scene)))
    mesh = None if grid else Mesh(np.asarray(jax.devices()[:ranks]),
                                  ('data',))
    return np.asarray(jax_spatial.spatial_inference(
        jmodel, variables, jnp.asarray(scene), mesh, grid=grid,
        softmax=False))


def _cli_case(directory, weights_seed=4):
    """The tiny leaf config on 4 synthetic tiles of 128², a random
    checkpoint of its model."""
    root = str(directory / 'data')
    make_synthetic_data_torch.main(['-o', osp.join(root, 'pots'), '--size',
                                    '128', '--num-train', '1',
                                    '--num-val', '0'])
    make_synthetic_data_torch.main(['-o', osp.join(root, 'vaih'), '--size',
                                    '128', '--num-train', '3',
                                    '--num-val', '0', '--seed', '1'])
    pack_dataset_torch.main([root, '--recursive'])
    cfg = tiny_config(root)
    cfg.merge_from_dict({'data.workers_per_gpu': 1})
    config = str(directory / 'tiny.py')
    cfg.dump(config)
    model = build_segmentor(dict(cfg.model)).init_weights(
        torch.Generator().manual_seed(weights_seed))
    ckpt = str(directory / 'tiny.pth')
    torch.save({'state_dict': model.state_dict()}, ckpt)
    return config, ckpt


@pytest.fixture(scope='module')
def spatial(tmp_path_factory):
    def compute():
        directory = shared_dir(tmp_path_factory) / 'spatial_ranks'
        directory.mkdir(exist_ok=True)
        jmodel = jax_segmentor(tiny_model_cfg())
        variables = jax_variables(jmodel, (1, 32, 32, 3), seed=6)
        port = load_port(build_segmentor(tiny_model_cfg()), variables)
        weights = port.state_dict()
        scenes = {name: _scene(hw, i) for i, (name, _, _, hw, _) in
                  enumerate(CASES)}
        job = {name: dict(kind='spatial', model=tiny_model_cfg(),
                          weights=weights, ranks=ranks, grid=grid,
                          pad=padded, scene=nchw(scenes[name]))
               for name, ranks, grid, _, padded in CASES}
        config, ckpt = _cli_case(directory)
        dataset = dict(n=5, size=48, num_classes=6, seed=2)
        job['test'] = dict(kind='spatial_test', model=tiny_model_cfg(),
                           weights=weights, dataset=dataset)
        four, two = directory / 'four', directory / 'two'
        four.mkdir(exist_ok=True)
        two.mkdir(exist_ok=True)
        procs = start_ranks(job, str(four), WORLD)
        procs2 = start_ranks({'test': dict(job['test'], config=config,
                                           checkpoint=ckpt)}, str(two), 2)
        try:
            refs = {name: _jax_logits(jmodel, variables, name, ranks, grid,
                                      scenes[name], padded)
                    for name, ranks, grid, _, padded in CASES}
            whole = {}
            with torch.inference_mode():
                for name, ranks, _, hw, padded in CASES:
                    img = nchw(scenes[name])
                    pad = (-hw[0]) % ranks if padded else 0
                    if pad:
                        img = torch.nn.functional.pad(img, (0, 0, 0, pad),
                                                      mode='replicate')
                    whole[name] = port.inference_logits(img)[0][
                        :, :, :hw[0]]
            singles = single_gpu_test(port, ToyLoader(ToyDataset(
                **dataset)), pre_eval=True, progress=False)
            cfg = Config.fromfile(config)
            ds = build_dataset({**cfg.data['test'], 'test_mode': True})
            cli_want = ds.evaluate(single_gpu_test(
                init_segmentor(cfg, ckpt, device='cpu'),
                build_dataloader(ds, 1, 1, shuffle=False), pre_eval=True,
                progress=False), metric='mIoU')
        finally:
            ranks = join_ranks(procs, str(four))
            ranks2 = join_ranks(procs2, str(two))
        return dict(ranks=ranks, ranks2=ranks2, refs=refs, whole=whole,
                    singles=singles, cli_want=cli_want, weights=weights)

    return shared_by_workers(tmp_path_factory, 'spatial', compute)


@pytest.mark.parametrize('case', [c[0] for c in CASES])
def test_spatial_inference_matches_jax(spatial, case):
    """Rank 0's gathered logits against the JAX function's (NHWC)."""
    got = spatial['ranks'][0][case]
    want = spatial['refs'][case]
    assert got.shape[2:] == want.shape[1:3]
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want,
                               **TOL)


@pytest.mark.parametrize('case', [c[0] for c in CASES])
def test_spatial_inference_is_the_whole_forward(spatial, case):
    """Every rank of the group gets the port's whole-scene logits (the
    edge-padding function, of the padded scene, cropped, on rank 0 only,
    where ``single_gpu_test`` reads them); ranks beyond the group take no
    part."""
    n, padded = next((r, p) for name, r, _, _, p in CASES if name == case)
    held = 1 if padded else n
    for rank in spatial['ranks'][:held]:
        np.testing.assert_allclose(rank[case].numpy(),
                                   spatial['whole'][case].numpy(),
                                   rtol=0, atol=1e-6)
    assert all(r[case] is None for r in spatial['ranks'][held:])


def test_padded_rows_enter_the_image_pool(spatial):
    """As in the JAX function, the edge-padded rows change the image
    pool, so the padded result is not the unpadded forward's."""
    scene = nchw(_scene((67, 64), 3))
    port = build_segmentor(tiny_model_cfg()).eval()
    port.load_state_dict(spatial['weights'])
    with torch.inference_mode():
        plain = port.inference_logits(scene)[0]
    got = spatial['ranks'][0]['pad_two']
    assert float((got - plain).abs().max()) > 1e-5


def test_single_gpu_test_spatial_is_single_gpu_test(spatial):
    """``single_gpu_test(spatial=n)`` on every rank of a group of 4 (and
    of 2): rank 0 returns ``single_gpu_test``'s results, the others
    None."""
    want = spatial['singles']
    for ranks in (spatial['ranks'], spatial['ranks2']):
        got = ranks[0]['test']['results']
        assert len(got) == len(want) == 5
        for a, b in zip(got, want):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        assert all(r['test']['results'] is None for r in ranks[1:])


def test_test_cli_spatial_gives_single_gpu_tests_miou(spatial):
    """``tools/test_torch.py --spatial 2`` on two ranks: rank 0's metrics
    are ``single_gpu_test``'s on the same images."""
    got = spatial['ranks2'][0]['test']['cli']
    assert got == spatial['cli_want']
    assert spatial['ranks2'][1]['test']['cli'] is None


def test_blocks_cut_at_multiples_of_eight():
    """The scene's stripes end at multiples of 8 (the cumulative stride),
    as even as that allows; a scene too small for its ranks raises."""
    grid = Grid(None, 1, 1)
    grid.n_h = 3
    grid.scene_cuts(100, 3, grid.rows)
    assert grid.rows[100] == [0, 32, 64, 100]
    with pytest.raises(ValueError, match='multiples of 8'):
        Grid(None, 1, 1).scene_cuts(12, 4, {})
    x = scatter_scene(torch.zeros(1, 3, 16, 24), Grid(None, 1, 1))
    assert x.shape == (1, 3, 16, 24)
