from .class_names import get_classes, get_palette
from .metrics import (eval_metrics, intersect_and_union,
                      pre_eval_to_metrics, total_area_to_metrics,
                      total_intersect_and_union)

__all__ = [
    'eval_metrics', 'intersect_and_union', 'pre_eval_to_metrics',
    'total_area_to_metrics', 'total_intersect_and_union', 'get_classes',
    'get_palette'
]
