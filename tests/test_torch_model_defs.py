"""Which of the 49 ``configs/_base_/models`` defs the port can build:
every component ``type`` of a def looked up in the port's registry, with
no JAX and no model built (a head's ``sampler`` in the pixel samplers'
registry). All 49 defs resolve every type; a def that did not would
raise the registry's ``KeyError`` at its first missing type. This pins
the count ROADMAP quotes (A13).
"""
import glob
import os.path as osp

import pytest

from pfst_tpu_torch.core.seg import PIXEL_SAMPLERS
from pfst_tpu_torch.models import MODELS
from pfst_tpu_torch.utils import Config

CONFIGS = osp.join(osp.dirname(__file__), '..', 'configs', '_base_',
                   'models')


def _types(node, out, key=''):
    """The component ``(key, type)`` pairs of a model dict in its order,
    leaving out those of ``*_cfg`` dicts (norms, activations)."""
    if isinstance(node, dict):
        if isinstance(node.get('type'), str) and not key.endswith('_cfg'):
            out.append((key, node['type']))
        for k, v in node.items():
            _types(v, out, k)
    elif isinstance(node, (list, tuple)):
        for v in node:
            _types(v, out, key)
    return out


# the defs the port builds (ROADMAP's count), and each other def's first
# type that no port registry holds
BUILDABLE = {'ann_r50-d8', 'annnet_r50-d8', 'apcnet_r50-d8',
             'bisenetv1_r18-d32', 'bisenetv2', 'ccnet_r50-d8', 'cgnet', 'danet_r50-d8',
             'deeplabv3_r50-d8', 'deeplabv3_unet_s5-d16',
             'deeplabv3plus_r50-d8', 'dmnet_r50-d8', 'dnl_r50-d8',
             'dpt_vit-b16', 'emanet_r50-d8', 'encnet_r50-d8', 'erfnet_fcn',
             'fast_scnn', 'fastfcn_r50-d32_jpu_psp', 'fcn_hr18', 'fcn_r50-d8',
             'fcn_unet_s5-d16', 'fpn_r50', 'gcnet_r50-d8', 'icnet_r50-d8',
             'isanet_r50-d8', 'knet_s3_fcn', 'lraspp_m-v3-d8',
             'nonlocal_r50-d8', 'ocrnet_hr18', 'ocrnet_r50-d8',
             'pointrend_r50', 'psanet_r50-d8', 'pspnet_r50-d8',
             'pspnet_unet_s5-d16', 'segformer_mit-b0',
             'segmenter_vit-b16_mask', 'setr_mla', 'setr_naive', 'setr_pup',
             'stdc', 'twins_pcpvt-s_fpn', 'twins_pcpvt-s_upernet',
             'upernet_beit', 'upernet_convnext', 'upernet_mae', 'upernet_r50',
             'upernet_swin', 'upernet_vit-b16_ln_mln'}
FIRST_MISSING = {}
MODEL_DEFS = sorted(glob.glob(osp.join(CONFIGS, '*.py')))


def _resolve(model):
    """Look every component type of ``model`` up in the port's registry
    (a head's ``sampler`` in the pixel samplers'), raising the registry's
    ``KeyError`` at the first it lacks."""
    for key, t in _types(model, []):
        registry = PIXEL_SAMPLERS if key == 'sampler' else MODELS
        if registry.get(t) is None:
            registry.build({'type': t})   # raises before building anything


def test_buildable_count_is_49_of_49():
    names = {osp.basename(p)[:-3] for p in MODEL_DEFS}
    assert len(names) == 49 and BUILDABLE | set(FIRST_MISSING) == names
    assert len(BUILDABLE) == 49 and not BUILDABLE & set(FIRST_MISSING)


@pytest.mark.parametrize('path', MODEL_DEFS, ids=osp.basename)
def test_model_def_resolves_in_the_port_registries(path):
    """A buildable def resolves every type; another raises ``KeyError``
    naming its first missing type. No model is built."""
    name = osp.basename(path)[:-3]
    model = Config.fromfile(path).to_dict()['model']
    if name in BUILDABLE:
        _resolve(model)
    else:
        # the registry's message, in the quotes of a KeyError's str()
        want = f'^.{FIRST_MISSING[name]} is not registered in models'
        with pytest.raises(KeyError, match=want):
            _resolve(model)
