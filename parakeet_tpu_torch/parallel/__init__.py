"""Device mesh, sharding and the explicit collectives of the port
(parallel/mesh.py, parallel/collectives.py).

The reference's pipeline names (parallel/pipeline.py: the GPipe trainer)
stay lazy as there; they are not ported yet (ROADMAP Queue 1 item 6b) and
raise NotImplementedError when asked for.
"""

from parakeet_tpu_torch.parallel.mesh import (
    batch_sharding,
    make_mesh,
    param_sharding_rules,
    shard_params,
)

_PIPELINE_NAMES = (
    "make_pp_trainer",
    "merge_layer_params",
    "pipeline_encode",
    "split_layer_params",
)


def __getattr__(name):
    if name in _PIPELINE_NAMES:
        raise NotImplementedError(
            f"parakeet_tpu_torch.parallel.{name}: pipeline parallelism is not ported yet (ROADMAP Queue 1 item 6b)"
        )
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "make_mesh",
    "param_sharding_rules",
    "shard_params",
    "batch_sharding",
    *_PIPELINE_NAMES,
]
