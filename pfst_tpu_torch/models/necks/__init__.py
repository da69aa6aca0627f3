from .featurepyramid import Feature2Pyramid
from .multilevel_neck import MultiLevelNeck

__all__ = ['Feature2Pyramid', 'MultiLevelNeck']
