from .neighborhood_sim import (cuda_neighborhood_similarity,
                               neighborhood_similarity,
                               torch_neighborhood_similarity)
from .resize import adaptive_avg_pool_1x1, resize
from .unfold import unfold_neighbors, unfold_valid_mask

__all__ = [
    'resize', 'adaptive_avg_pool_1x1', 'unfold_neighbors',
    'unfold_valid_mask', 'neighborhood_similarity',
    'torch_neighborhood_similarity', 'cuda_neighborhood_similarity'
]
