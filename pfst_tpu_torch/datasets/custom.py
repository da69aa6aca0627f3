"""Folder-scan segmentation dataset (port of
``pfst_tpu/datasets/custom.py``; mirrors ``rsiseg/datasets/custom.py:377-
856``): img_dir/ann_dir scanning (or a split file), the pipeline, per-image
``pre_eval`` histograms and ``evaluate``'s mIoU/mDice/mFscore tables, with
label_map and reduce_zero_label; ``format_results`` writes predictions
as 8-bit PNG label maps with the port's PNG writer.
"""
from __future__ import annotations

import os
import os.path as osp
from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np

from ..core.evaluation import (eval_metrics, intersect_and_union,
                               pre_eval_to_metrics)
from ..utils.logger import get_root_logger, print_log
from .builder import DATASETS
from .pipelines import Compose
from .pipelines.loading import imread
from .pipelines.png import write_png


def scandir(dir_path, suffix=None, recursive=False):
    for entry in sorted(os.scandir(dir_path), key=lambda e: e.name):
        if entry.is_file():
            if suffix is None or entry.name.endswith(suffix):
                yield entry.name
        elif recursive and entry.is_dir():
            for sub in scandir(entry.path, suffix, recursive):
                yield osp.join(entry.name, sub)


@DATASETS.register_module()
class CustomDataset:
    CLASSES: Optional[Sequence[str]] = None
    PALETTE: Optional[Sequence[Sequence[int]]] = None

    def __init__(self,
                 pipeline,
                 img_dir='',
                 img_suffix='.jpg',
                 ann_dir=None,
                 seg_map_suffix='.png',
                 split=None,
                 data_root=None,
                 test_mode=False,
                 ignore_index=255,
                 reduce_zero_label=False,
                 classes=None,
                 palette=None,
                 gt_seg_map_loader_cfg=None,
                 file_client_args=None):
        self.pipeline = Compose(pipeline)
        self.img_dir = img_dir
        self.img_suffix = img_suffix
        self.ann_dir = ann_dir
        self.seg_map_suffix = seg_map_suffix
        self.split = split
        self.data_root = data_root
        self.test_mode = test_mode
        self.ignore_index = ignore_index
        self.reduce_zero_label = reduce_zero_label
        self.label_map = None
        self.CLASSES, self.PALETTE = self.get_classes_and_palette(
            classes, palette)
        self.gt_loader_reduce_zero = (gt_seg_map_loader_cfg or {}).get(
            'reduce_zero_label', self.reduce_zero_label)

        if self.data_root is not None:
            if not osp.isabs(self.img_dir):
                self.img_dir = osp.join(self.data_root, self.img_dir)
            if self.ann_dir is not None and not osp.isabs(self.ann_dir):
                self.ann_dir = osp.join(self.data_root, self.ann_dir)
            if self.split is not None and not osp.isabs(self.split):
                self.split = osp.join(self.data_root, self.split)

        self.img_infos = self.load_annotations(
            self.img_dir, self.img_suffix, self.ann_dir,
            self.seg_map_suffix, self.split)

    def __len__(self):
        return len(self.img_infos)

    def load_annotations(self, img_dir, img_suffix, ann_dir,
                         seg_map_suffix, split):
        """(``custom.py:495-538``)."""
        img_infos = []
        if split is not None:
            with open(split) as f:
                for line in f:
                    name = line.strip()
                    info = dict(filename=name + img_suffix)
                    if ann_dir is not None:
                        info['ann'] = dict(seg_map=name + seg_map_suffix)
                    img_infos.append(info)
        else:
            for img in scandir(img_dir, img_suffix, recursive=True):
                info = dict(filename=img)
                if ann_dir is not None:
                    seg_map = img.replace(img_suffix, seg_map_suffix)
                    info['ann'] = dict(seg_map=seg_map)
                img_infos.append(info)
            img_infos = sorted(img_infos, key=lambda x: x['filename'])
        print_log(f'Loaded {len(img_infos)} images', get_root_logger())
        return img_infos

    def get_ann_info(self, idx):
        return self.img_infos[idx]['ann']

    def pre_pipeline(self, results):
        results['seg_fields'] = []
        results['img_prefix'] = self.img_dir
        results['seg_prefix'] = self.ann_dir
        if self.custom_classes:
            results['label_map'] = self.label_map

    @property
    def custom_classes(self):
        return self.label_map is not None

    def prepare_train_img(self, idx):
        img_info = self.img_infos[idx]
        results = dict(img_info=img_info, ann_info=img_info.get('ann'))
        self.pre_pipeline(results)
        return self.pipeline(results)

    def prepare_test_img(self, idx):
        results = dict(img_info=self.img_infos[idx])
        self.pre_pipeline(results)
        return self.pipeline(results)

    def __getitem__(self, idx):
        if self.test_mode:
            return self.prepare_test_img(idx)
        return self.prepare_train_img(idx)

    # -- ground truth for evaluation --------------------------------------
    def get_gt_seg_map_by_idx(self, index):
        info = self.img_infos[index]
        gt = imread(osp.join(self.ann_dir, info['ann']['seg_map']),
                    unchanged=True)
        if gt.ndim == 3:
            gt = gt[..., 0]
        if self.label_map is not None:
            out = gt.copy()
            for old_id, new_id in self.label_map.items():
                out[gt == old_id] = new_id
            gt = out
        if self.gt_loader_reduce_zero:
            gt = gt.astype(np.int32)
            gt[gt == 0] = 255
            gt = gt - 1
            gt[gt == 254] = 255
        return gt.astype(np.int32)

    def get_gt_seg_maps(self):
        for idx in range(len(self)):
            yield self.get_gt_seg_map_by_idx(idx)

    # -- evaluation (``custom.py:644-856``) --------------------------------
    def pre_eval(self, preds, indices):
        if not isinstance(indices, list):
            indices = [indices]
        if not isinstance(preds, list):
            preds = [preds]
        return [intersect_and_union(pred, self.get_gt_seg_map_by_idx(index),
                                    len(self.CLASSES), self.ignore_index)
                for pred, index in zip(preds, indices)]

    def get_classes_and_palette(self, classes=None, palette=None):
        if classes is None:
            self.label_map = None
            return self.CLASSES, self.PALETTE
        if isinstance(classes, str):
            with open(classes) as f:
                class_names = [line.strip() for line in f]
        else:
            class_names = list(classes)
        if self.CLASSES:
            if not set(class_names).issubset(self.CLASSES):
                raise ValueError('classes is not a subset of CLASSES.')
            self.label_map = {}
            for i, c in enumerate(self.CLASSES):
                self.label_map[i] = 255 if c not in class_names \
                    else class_names.index(c)
        palette = self.get_palette_for_custom_classes(class_names, palette)
        return class_names, palette

    def get_palette_for_custom_classes(self, class_names, palette=None):
        if self.label_map is not None:
            pal = [self.PALETTE[old_id] for old_id, new_id in
                   sorted(self.label_map.items(), key=lambda x: x[1])
                   if new_id != 255]
            palette = type(self.PALETTE)(pal) if self.PALETTE else pal
        elif palette is None:
            if self.PALETTE is None:
                rs = np.random.RandomState(42)
                palette = rs.randint(0, 255,
                                     size=(len(class_names), 3)).tolist()
            else:
                palette = self.PALETTE
        return palette

    def evaluate(self, results, metric='mIoU', logger=None,
                 gt_seg_maps=None, **kwargs):
        """Per-class table and overall metrics (``custom.py:756-856``),
        from ``pre_eval`` tuples or from label maps."""
        if isinstance(metric, str):
            metric = [metric]
        allowed = ['mIoU', 'mDice', 'mFscore']
        if not set(metric).issubset(set(allowed)):
            raise KeyError(f'metric {metric} is not supported')
        if len(results) > 0 and isinstance(results[0], tuple):
            ret_metrics = pre_eval_to_metrics(results, metric)
        else:
            if gt_seg_maps is None:
                gt_seg_maps = list(self.get_gt_seg_maps())
            ret_metrics = eval_metrics(
                results, gt_seg_maps, len(self.CLASSES),
                self.ignore_index, metric)
        class_names = self.CLASSES

        ret_metrics_summary = OrderedDict({
            m: np.round(np.nanmean(v) * 100, 2)
            for m, v in ret_metrics.items()
        })
        ret_metrics.pop('aAcc', None)
        ret_metrics_class = OrderedDict({
            m: np.round(v * 100, 2) for m, v in ret_metrics.items()
        })
        lines = ['per class results:']
        header = ['Class'] + list(ret_metrics_class.keys())
        lines.append(' | '.join(f'{h:>12}' for h in header))
        for i, name in enumerate(class_names):
            row = [name] + [str(ret_metrics_class[m][i])
                            for m in ret_metrics_class]
            lines.append(' | '.join(f'{v:>12}' for v in row))
        lines.append('Summary: ' + ', '.join(
            f'{m}: {v}' for m, v in ret_metrics_summary.items()))
        print_log('\n'.join(lines), logger or get_root_logger())

        eval_results = {}
        for m, v in ret_metrics_summary.items():
            if m == 'aAcc':
                eval_results[m] = v / 100.0
            else:
                eval_results['m' + m] = v / 100.0
        for m, values in ret_metrics_class.items():
            eval_results.update({
                f'{m}.{name}': values[i] / 100.0
                for i, name in enumerate(class_names)
            })
        return eval_results

    def results2img(self, results, imgfile_prefix, to_label_id=None,
                    indices=None):
        """Write each label map of ``results`` as an 8-bit grayscale PNG
        named after its image, under ``imgfile_prefix``
        (``custom.py:274-298``); ``to_label_id`` maps train ids to label
        ids. Returns the paths."""
        os.makedirs(imgfile_prefix, exist_ok=True)
        indices = indices if indices is not None else range(len(results))
        files = []
        for res, idx in zip(results, indices):
            name = osp.splitext(osp.basename(
                self.img_infos[idx]['filename']))[0]
            out = np.asarray(res).astype(np.uint8)
            if to_label_id:
                mapped = out.copy()
                for train_id, label_id in to_label_id.items():
                    mapped[out == train_id] = label_id
                out = mapped
            path = osp.join(imgfile_prefix, f'{name}.png')
            write_png(path, out)
            files.append(path)
        return files

    def format_results(self, results, imgfile_prefix, to_label_id=None,
                       indices=None):
        """``results2img`` (``custom.py:301-305``)."""
        return self.results2img(results, imgfile_prefix, to_label_id,
                                indices)
