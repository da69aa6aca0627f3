"""The port's train loop, checkpoints and CLIs on the CPU, against the
JAX package where it has a counterpart.

A tiny ``train_segmentor`` run (the Pots->Vaih leaf config at the tiny
widths of ``test_torch_slice.py``, 64x64 crops of synthetic 128x128
tiles written and packed by the port's tools, 4 iterations, a checkpoint
at 2 and at 4, an eval at 4) and a run resumed from its checkpoint at 2:

* the restored state equals the checkpoint bitwise, and the resumed run
  takes the first run's third batch first;
* the JAX package's ``single_gpu_test``, on the port's checkpoint carried
  by ``tools/convert_torch_checkpoint.py::convert_state_dict``, scores the
  port's in-loop mIoU within 0.01 points;
* ``tools/train_torch.py`` and ``tools/test_torch.py`` run in-process;
* ``tools/convert_jax_checkpoint_torch.py`` carries a JAX train state
  into a checkpoint the port resumes from;
* the config branches the port does not do raise; the TensorBoard and
  W&B hooks run in the loop.
"""
import glob
import json
import os.path as osp
import sys
import types

import numpy as np
import pytest
import torch

# torch's OpenMP pool must not run beside XLA-CPU in one process
torch.set_num_threads(1)

import jax  # noqa: E402

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, osp.join(REPO, 'tools'))

import convert_jax_checkpoint_torch  # noqa: E402
import make_synthetic_data_torch  # noqa: E402
import pack_dataset_torch  # noqa: E402
import test_torch  # noqa: E402
import train_torch  # noqa: E402
from convert_torch_checkpoint import convert_state_dict  # noqa: E402
from torch_parity import jax_variables  # noqa: E402

from pfst_tpu.apis import single_gpu_test as jax_single_gpu_test  # noqa: E402
from pfst_tpu.core.checkpoint import save_checkpoint as save_orbax  # noqa: E402
from pfst_tpu.datasets import build_dataloader as jax_loader  # noqa: E402
from pfst_tpu.datasets import build_dataset as jax_dataset  # noqa: E402
from pfst_tpu.models import build_segmentor as jax_segmentor  # noqa: E402
from pfst_tpu.utils import Config as JaxConfig  # noqa: E402
from pfst_tpu_torch.apis import (build_algorithm, inference_segmentor,  # noqa: E402
                                 init_segmentor, single_gpu_test,
                                 train_segmentor)
from pfst_tpu_torch.core import (build_optimizer, load_checkpoint,  # noqa: E402
                                 load_weights_into_state, restore_state,
                                 torch_key_to_flax)
from pfst_tpu_torch.core.checkpoint import state_dict_of  # noqa: E402
from pfst_tpu_torch.core.hooks.tb_events import read_events  # noqa: E402
from pfst_tpu_torch.datasets import build_dataloader, build_dataset  # noqa: E402
from pfst_tpu_torch.datasets.pipelines import imread  # noqa: E402
from pfst_tpu_torch.utils import Config  # noqa: E402

LEAF = osp.join(REPO, 'configs', 'pfst',
                'pfst_pots_irrg2vaih_irrg_deeplabv3plus_r50-d8.py')
TINY = {
    'model.backbone.depth': 18, 'model.backbone.base_channels': 8,
    'model.backbone.stem_channels': 8,
    'model.decode_head.in_channels': 64, 'model.decode_head.channels': 16,
    'model.decode_head.c1_in_channels': 8,
    'model.decode_head.c1_channels': 4,
    'model.auxiliary_head.in_channels': 32,
    'model.auxiliary_head.channels': 8,
}
MIOU_TOL = 1e-4     # 0.01 points
ITERS, RESUME = 4, 2


def tiny_config(root):
    """The leaf config, tiny, on the synthetic roots under ``root``."""
    cfg = Config.fromfile(LEAF)
    pots, vaih = osp.join(root, 'pots'), osp.join(root, 'vaih')
    cfg.merge_from_dict({
        **TINY,
        'data.train.source.data_root': pots,
        'data.train.target.data_root': vaih,
        'data.val.data_root': vaih, 'data.test.data_root': vaih,
        'data.test.img_dir': 'img_dir/train',
        'data.test.ann_dir': 'ann_dir/train',
        'data.workers_per_gpu': 2,
        'log_config.interval': 1, 'checkpoint_config.interval': RESUME,
        'evaluation.interval': ITERS, 'lr_config.warmup_iters': 1})
    for name, scale in (('source', (72, 72)), ('target', (128, 128))):
        for t in cfg.data.train[name].pipeline:
            if t['type'] == 'Resize':
                t['img_scale'] = scale
            if t['type'] == 'RandomCrop':
                t['crop_size'] = (64, 64)
            if t['type'] == 'Pad':
                t['size'] = (64, 64)
    for key in ('val', 'test'):
        cfg.data[key].pipeline[1]['img_scale'] = (128, 128)
    return cfg


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('loop'))
    make_synthetic_data_torch.main(['-o', osp.join(root, 'pots'), '--size',
                                    '128', '--num-train', '4',
                                    '--num-val', '0'])
    make_synthetic_data_torch.main(['-o', osp.join(root, 'vaih'), '--size',
                                    '128', '--num-train', '4',
                                    '--num-val', '2', '--seed', '1'])
    assert pack_dataset_torch.main([root, '--recursive']) == 20
    cfg = tiny_config(root)
    cfg_path = osp.join(root, 'tiny.py')
    cfg.dump(cfg_path)
    hist_a, hist_b = [], []
    train_segmentor(cfg.copy(), work_dir=osp.join(root, 'A'),
                    max_iters_override=ITERS, device='cpu', history=hist_a)
    train_segmentor(cfg.copy(), work_dir=osp.join(root, 'B'),
                    resume_from=osp.join(root, 'A', f'iter_{RESUME}.pth'),
                    max_iters_override=ITERS, device='cpu', validate=False,
                    history=hist_b)
    return dict(root=root, cfg=cfg, cfg_path=cfg_path, a=hist_a, b=hist_b)


def _fresh_state(cfg):
    opt_cfg = cfg.get('optimizer_config') or {}
    tx = build_optimizer(cfg.optimizer, cfg.get('lr_config'), ITERS,
                         opt_cfg.get('grad_clip'))
    return build_algorithm(cfg, device='cpu').init_state(
        torch.Generator().manual_seed(1), tx)


def test_run_records_logs_checkpoints_and_eval(runs):
    kinds = [(h['kind'], h['iter']) for h in runs['a']
             if h['kind'] != 'batch']
    assert kinds == [('log', 1), ('log', 2), ('checkpoint', 2), ('log', 3),
                     ('log', 4), ('checkpoint', 4), ('eval', 4)]
    for h in runs['a']:
        if h['kind'] == 'log':
            assert all(np.isfinite(v) for v in h['log_vars'].values())


def test_resume_restores_the_state_exactly(runs):
    path = osp.join(runs['root'], 'A', f'iter_{RESUME}.pth')
    ckpt = load_checkpoint(path)
    state = restore_state(_fresh_state(runs['cfg']), ckpt)
    got, want = state_dict_of(state), ckpt['state_dict']
    assert got.keys() == want.keys()
    assert any(k.startswith('ema_model.') for k in want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    opt = state.optimizer.optimizer.state_dict()
    assert opt['state'].keys() == ckpt['optimizer']['state'].keys()
    for i, saved in ckpt['optimizer']['state'].items():
        for k, v in saved.items():
            assert torch.equal(opt['state'][i][k], v), (i, k)
    assert state.step == RESUME
    assert state.optimizer.scheduler.last_epoch == RESUME
    assert state.optimizer.lr == pytest.approx(
        ckpt['optimizer']['param_groups'][0]['lr'], rel=0, abs=0)
    batches_a = {h['iter']: h['indices'] for h in runs['a']
                 if h['kind'] == 'batch'}
    batches_b = [h for h in runs['b'] if h['kind'] == 'batch']
    assert [h['iter'] for h in batches_b] == list(range(RESUME + 1,
                                                        ITERS + 1))
    assert [h['indices'] for h in batches_b] == \
        [batches_a[i] for i in range(RESUME + 1, ITERS + 1)]


def test_load_from_warm_starts_the_student_and_teacher(runs):
    ckpt = load_checkpoint(osp.join(runs['root'], 'A', f'iter_{ITERS}.pth'))
    state = load_weights_into_state(_fresh_state(runs['cfg']), ckpt)
    student = state.student.state_dict()
    for k, v in ckpt['state_dict'].items():
        if k.startswith('model.'):
            assert torch.equal(student[k[len('model.'):]], v), k
    for k, v in state.teacher.state_dict().items():
        assert torch.equal(v, student[k]), k
    assert state.step == 0 and not state.optimizer.optimizer.state


def test_jax_single_gpu_test_scores_the_port_checkpoint(runs):
    loop_miou = next(h['metrics']['mIoU'] for h in runs['a']
                     if h['kind'] == 'eval')
    sd = load_checkpoint(osp.join(runs['root'], 'A',
                                  f'iter_{ITERS}.pth'))['state_dict']
    # the student, as the tool's main selects it (``:588-602``)
    params, batch_stats, skipped = convert_state_dict(
        {k: v for k, v in sd.items() if k.startswith('model.')}, 'model.')
    assert not [k for k in skipped if 'num_batches' not in k], skipped
    cfg = JaxConfig.fromfile(runs['cfg_path'])
    model_cfg = dict(cfg.model)
    model_cfg['pretrained'] = None
    model_cfg.pop('train_cfg', None)
    model = jax_segmentor(model_cfg)
    shapes = jax_variables(model, (1, 64, 64, 3))
    variables = {'params': params, 'batch_stats': batch_stats}
    assert jax.tree.structure(variables) == jax.tree.structure(shapes)
    dataset = jax_dataset({**cfg.data['val'], 'test_mode': True})
    results = jax_single_gpu_test(model, variables,
                                  jax_loader(dataset, 1, 1, shuffle=False))
    jax_miou = dataset.evaluate(results, metric='mIoU',
                                logger='silent')['mIoU']
    assert abs(jax_miou - loop_miou) <= MIOU_TOL + 1e-12, \
        (jax_miou, loop_miou)


def test_train_and_test_clis_run_in_process(runs, tmp_path):
    work = str(tmp_path / 'cli')
    state = train_torch.main([runs['cfg_path'], '--work-dir', work,
                              '--max-iters', '1', '--device', 'cpu',
                              '--no-validate'])
    assert state.step == 1 and osp.isfile(osp.join(work, 'iter_1.pth'))
    res = test_torch.main([runs['cfg_path'],
                           osp.join(runs['root'], 'A', f'iter_{ITERS}.pth'),
                           '--eval', 'mIoU', '--device', 'cpu'])
    loop_miou = next(h['metrics']['mIoU'] for h in runs['a']
                     if h['kind'] == 'eval')
    assert abs(res['mIoU'] - loop_miou) <= MIOU_TOL + 1e-12


def test_inference_segmentor_labels_as_single_gpu_test(runs):
    ckpt = osp.join(runs['root'], 'A', f'iter_{ITERS}.pth')
    model = init_segmentor(runs['cfg_path'], ckpt, device='cpu')
    dataset = build_dataset({**runs['cfg'].data['test'], 'test_mode': True})
    want = single_gpu_test(model, build_dataloader(dataset, 1, 1,
                                                   shuffle=False),
                           pre_eval=False)[0]
    path = osp.join(dataset.img_dir, dataset.img_infos[0]['filename'])
    for img in (path, imread(path)):
        got = inference_segmentor(model, img)
        assert got.shape == want.shape == (128, 128)
        np.testing.assert_array_equal(got, want)


def test_jax_train_state_converts_into_a_port_checkpoint(runs, tmp_path):
    cfg = runs['cfg']
    state = _fresh_state(cfg)
    model = jax_segmentor({**dict(JaxConfig.fromfile(runs['cfg_path'])
                                  .model), 'pretrained': None})
    student = jax_variables(model, (1, 64, 64, 3), seed=3)
    teacher = jax_variables(model, (1, 64, 64, 3), seed=4)
    tree = {'params': student['params'],
            'batch_stats': student['batch_stats'],
            'ema_params': teacher['params'],
            'ema_batch_stats': teacher['batch_stats'],
            'step': np.asarray(3, np.int32)}
    orbax_dir = save_orbax(str(tmp_path / 'jax'), 3, tree)
    out = convert_jax_checkpoint_torch.main([
        runs['cfg_path'], orbax_dir, str(tmp_path / 'port' / 'c.pth')])
    state = restore_state(state, load_checkpoint(out))
    assert state.step == 3 and state.optimizer.scheduler.last_epoch == 3
    w = 'decode_head.conv_seg.weight'
    coll, path = torch_key_to_flax(w, 4)
    kernel = student[coll]
    for name in path:
        kernel = kernel[name]
    np.testing.assert_array_equal(
        state.student.state_dict()[w].numpy(),
        np.asarray(kernel).transpose(3, 2, 0, 1))
    assert not torch.equal(state.student.state_dict()[w],
                           state.teacher.state_dict()[w])


class _Wandb(types.ModuleType):
    """A stand-in ``wandb`` module recording its calls."""

    def __init__(self):
        super().__init__('wandb')
        self.calls = []
        self.Image = lambda a: ('image', np.asarray(a))
        self.Histogram = lambda a: ('histogram', np.asarray(a))

    def init(self, **kw):
        self.calls.append(('init', kw))

    def log(self, payload, step=None):
        self.calls.append(('log', step, payload))

    def finish(self):
        self.calls.append(('finish',))


@pytest.mark.parametrize('option', [
    {'parallel.sp': 2}, {'qat': {'bits': 8}},
    {'log_config.hooks': [{'type': 'TensorboardLoggerHook',
                           'interval': 1}]},
    {'data.decode_cache_mb': 64},
    {'custom_hooks': [{'type': 'WandbHookSeg', 'interval': 1}]},
])
def test_waiting_config_branches_raise(runs, option, tmp_path, monkeypatch):
    """What the port does not do raises (spatially sharded training,
    ``parallel.sp``; ``parallel.tp`` trains under a launcher since the
    sharded modes, ``tests/test_torch_zero_tp.py``). The TensorBoard and
    W&B hooks waited for the A12 hook slice and run now: the event file
    holds the loop's log vars at each iteration, and with W&B (a stand-in
    module) the loop collects the step's visualisation states, whose
    density map the hook logs as an image. ``qat`` waited for the quantization slice
    and trains now: an iteration under fake quantization with finite
    losses."""
    cfg = runs['cfg'].copy()
    cfg.merge_from_dict(option)
    hooks = option.get('log_config.hooks') or option.get('custom_hooks')
    if 'qat' in option:
        hist = []
        state = train_segmentor(cfg, max_iters_override=1, device='cpu',
                                validate=False, history=hist)
        (log,) = [h['log_vars'] for h in hist if h['kind'] == 'log']
        assert state.step == 1 and all(np.isfinite(list(log.values())))
        return
    if not hooks:
        with pytest.raises(NotImplementedError, match='ROADMAP|pack'):
            train_segmentor(cfg, max_iters_override=1, device='cpu')
        return
    wandb = _Wandb()
    monkeypatch.setitem(sys.modules, 'wandb', wandb)
    hist = []
    state = train_segmentor(cfg, work_dir=str(tmp_path),
                            max_iters_override=1, device='cpu',
                            validate=False, history=hist)
    assert state.step == 1
    logs = [h['log_vars'] for h in hist if h['kind'] == 'log']
    if hooks[0]['type'] == 'TensorboardLoggerHook':
        (path,) = glob.glob(str(tmp_path / 'tb' / 'events.out.tfevents.*'))
        events = read_events(path)
        assert events[0]['file_version'] == 'brain.Event:2'
        assert [e['step'] for e in events[1:]] == [1]
        got = dict(events[1]['scalars'])
        assert got.keys() == logs[0].keys()
        for k, v in logs[0].items():
            assert got[k] == np.float32(v), k
        return
    (log,) = [c for c in wandb.calls if c[0] == 'log']
    assert log[1] == 1 and log[2]['loss'] == pytest.approx(
        logs[0]['loss'], rel=1e-6)
    # the loss's map: the head's 16x16 logits downscaled by 0.5
    kind, density = log[2]['vis|density_sim_feat/0']
    assert kind == 'image' and density.shape == (8, 8)
    assert np.isfinite(density).all()
    assert wandb.calls[-1] == ('finish',)


def test_analyze_logs_parses_the_port_log_lines(runs):
    """``tools/analyze_logs.py`` (which imports neither JAX nor its
    package) reads the port loop's ``Iter [N/M] time: ... data: ...``
    lines with every log var."""
    import analyze_logs
    recs = analyze_logs.parse_log(osp.join(runs['root'], 'A', 'train.log'))
    logs = [h for h in runs['a'] if h['kind'] == 'log']
    # run A's lines first (the root logger's file handler stays open for
    # the later runs of this process)
    recs = recs[:len(logs)]
    assert [r['iter'] for r in recs] == [h['iter'] for h in logs]
    for r, h in zip(recs, logs):
        for k, v in h['log_vars'].items():
            assert r[k] == pytest.approx(v, abs=1e-4), k
        assert r['time'] == pytest.approx(h['time'], abs=1e-3)


def test_benchmark_tool_writes_its_json(runs, tmp_path):
    """``tools/benchmark_torch.py`` (``tools/benchmark.py``'s arguments
    and JSON keys) on the tiny config, on the CPU."""
    import benchmark_torch
    summary = benchmark_torch.main([
        runs['cfg_path'], osp.join(runs['root'], 'A', f'iter_{ITERS}.pth'),
        '--num-images', '3', '--warmup', '1', '--repeat-times', '2',
        '--work-dir', str(tmp_path), '--device', 'cpu',
        '--cfg-options', 'crop_size=(64,64)'])
    with open(tmp_path / 'benchmark.json') as f:
        written = json.load(f)
    assert written == summary
    assert set(summary) == {'fps', 'fps_std', 'num_images'}
    assert summary['fps'] > 0 and summary['num_images'] == 3
