from .config import (ALL_SHAPES, SHAPES_BY_NAME, ModelConfig, ShapeConfig,
                     shapes_for)
from .transformer import (CacheLeaf, Model, build_model, cache_shapes,
                          forward, init_cache, lm_loss, map_cache,
                          model_defs)
from .params import (LayerStack, ParamDef, ParamTree, Stacked,
                     abstract_params, count_params, init_params, is_def,
                     map_defs, map_params, stack_defs, trainable,
                     tree_leaves)
