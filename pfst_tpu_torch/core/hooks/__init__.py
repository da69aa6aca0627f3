from .hook import HOOKS, Hook, build_hook
from .loggers import (MMSegWandbHook, ProfilerHook, TensorboardLoggerHook,
                      TextLoggerHook, WandbHookSeg, WandbHookStatistics)
from .plot_statistics_hook import (PlotMultiClassStatisticsHook,
                                   PlotStatisticsHook, similarity_histogram)
from .pseudo_labeling_hook import (PseudoLabelingHook, PseudoLabelingHookV2,
                                   PseudoLabelingHookV3, PseudoLabelingHookV4,
                                   _StopTraining)
from .rare_class_sampling_hook import (RareClassSamplingHook,
                                       compute_class_stats)

__all__ = [
    'HOOKS', 'Hook', 'build_hook', 'TextLoggerHook', 'TensorboardLoggerHook',
    'WandbHookSeg', 'MMSegWandbHook', 'WandbHookStatistics', 'ProfilerHook',
    'PlotStatisticsHook', 'PlotMultiClassStatisticsHook',
    'similarity_histogram', 'RareClassSamplingHook', 'compute_class_stats',
    'PseudoLabelingHook', 'PseudoLabelingHookV2', 'PseudoLabelingHookV3',
    'PseudoLabelingHookV4', '_StopTraining'
]
