#!/usr/bin/env python
"""Pseudo-label corpus generation with the PyTorch port (the counterpart of
``tools/gen_pseudo_labels.py``, with the same arguments)::

    python tools/gen_pseudo_labels_torch.py <config> <checkpoint> \\
        --out-dir work_dirs/pseudo_labels/<name> [--split val] \\
        [--save-feats --feat-levels 3 --mean-sim 0.6]

``checkpoint`` is a port checkpoint (``iter_<N>.pth``; a UDA one gives its
student). Per image of the split it writes ``<image name>.h5`` with
``seg_logits``, the 11 ``thre@{ratio}`` entropy thresholds and, with
``--save-feats``, ``feats_{lvl}`` and ``gaussian_sim_feat_{lvl}``, plus
``sigmas.json`` (``pfst_tpu_torch/apis/pseudo_labels.py``). Train a domain
adaptor on the corpus with ``LoadAnnotationsPseudoLabelsV2(
pseudo_labels_dir=<out-dir>, pseudo_ratio=<ratio>)`` in its target
pipeline. Runs on the card unless ``--device cpu``.
"""
import os.path as osp
import sys

sys.path.insert(0, osp.join(osp.dirname(osp.abspath(__file__)), '..'))

from pfst_tpu_torch.apis.pseudo_labels import main  # noqa: E402

if __name__ == '__main__':
    main()
