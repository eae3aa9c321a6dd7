from .config import (ALL_SHAPES, SHAPES_BY_NAME, ModelConfig, ShapeConfig,
                     shapes_for)
from .transformer import (CacheLeaf, Model, build_model, cache_shapes,
                          forward, init_cache, map_cache, model_defs)
from .params import (ParamDef, ParamTree, Stacked, count_params, init_params,
                     stack_defs)
