"""Device mesh, sharding, the explicit collectives of the port and the
GPipe pipeline trainer (parallel/mesh.py, parallel/collectives.py,
parallel/pipeline.py).

The pipeline names load lazily, as in the reference: parallel/pipeline.py
imports the encoder, which imports parallel/collectives.py.
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
        from parakeet_tpu_torch.parallel import pipeline

        return getattr(pipeline, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "make_mesh",
    "param_sharding_rules",
    "shard_params",
    "batch_sharding",
    *_PIPELINE_NAMES,
]
