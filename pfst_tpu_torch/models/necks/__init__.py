from .multilevel_neck import MultiLevelNeck

__all__ = ['MultiLevelNeck']
