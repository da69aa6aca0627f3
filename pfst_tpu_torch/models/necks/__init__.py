from .featurepyramid import Feature2Pyramid
from .fpn import FPN
from .ic_neck import ICNeck
from .jpu import JPU
from .mla_neck import MLANeck
from .multilevel_neck import MultiLevelNeck

__all__ = ['Feature2Pyramid', 'FPN', 'ICNeck', 'JPU', 'MLANeck',
           'MultiLevelNeck']
