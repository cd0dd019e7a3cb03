"""Elastic batch sizing: the solver that picks a global batch size valid
at many world sizes (the port's copy of deepspeed_tpu/elasticity's
`elasticity.py` and `constants.py`; the supervisor, `elastic_agent` and
`elastic_env` are not ported yet)."""

from .elasticity import (  # noqa: F401
    ElasticityConfig,
    ElasticityConfigError,
    ElasticityError,
    ElasticityIncompatibleWorldSize,
    compute_elastic_config,
    elasticity_enabled,
    ensure_immutable_elastic_config,
    get_compatible_gpus_v01,
)
