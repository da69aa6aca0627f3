from .hook import HOOKS, Hook, build_hook
from .loggers import TextLoggerHook
from .plot_statistics_hook import (PlotMultiClassStatisticsHook,
                                   PlotStatisticsHook, similarity_histogram)
from .pseudo_labeling_hook import (PseudoLabelingHook, PseudoLabelingHookV2,
                                   PseudoLabelingHookV3, PseudoLabelingHookV4,
                                   _StopTraining)
from .rare_class_sampling_hook import (RareClassSamplingHook,
                                       compute_class_stats)

# the JAX package's hooks that wait for the next A12 slice (ROADMAP A12):
# train_segmentor raises for them by name instead of skipping them
WAITING_HOOKS = ('TensorboardLoggerHook', 'WandbHookSeg', 'MMSegWandbHook',
                 'WandbHookStatistics', 'ProfilerHook')

__all__ = [
    'HOOKS', 'Hook', 'build_hook', 'TextLoggerHook', 'PlotStatisticsHook',
    'PlotMultiClassStatisticsHook', 'similarity_histogram',
    'RareClassSamplingHook', 'compute_class_stats', 'PseudoLabelingHook',
    'PseudoLabelingHookV2', 'PseudoLabelingHookV3', 'PseudoLabelingHookV4',
    '_StopTraining', 'WAITING_HOOKS'
]
