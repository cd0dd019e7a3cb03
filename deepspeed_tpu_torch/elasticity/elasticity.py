"""Elastic batch-size solver — the port's copy of
deepspeed_tpu/elasticity/elasticity.py (reference:
deepspeed/elasticity/elasticity.py:240-334).

Pure arithmetic, hardware-agnostic: choose a global batch size compatible
with many accelerator counts so a restarted job can resume at a different
world size with identical convergence. "gpus" in names kept for schema
parity; on TPU a "gpu" is a chip.
"""

from ..utils.logging import logger
from . import constants as ec


class ElasticityError(Exception):
    pass


class ElasticityConfigError(ElasticityError):
    pass


class ElasticityIncompatibleWorldSize(ElasticityError):
    pass


class ElasticityConfig:
    """Schema-parity config holder (reference elasticity/config.py)."""

    def __init__(self, param_dict):
        self.enabled = param_dict.get(ec.ENABLED, ec.ENABLED_DEFAULT)
        if ec.MAX_ACCEPTABLE_BATCH_SIZE not in param_dict and self.enabled:
            raise ElasticityConfigError(
                f"'{ec.MAX_ACCEPTABLE_BATCH_SIZE}' is required in elasticity config")
        self.max_acceptable_batch_size = param_dict.get(
            ec.MAX_ACCEPTABLE_BATCH_SIZE, ec.MAX_ACCEPTABLE_BATCH_SIZE_DEFAULT)
        self.micro_batches = param_dict.get(ec.MICRO_BATCHES, ec.MICRO_BATCHES_DEFAULT)
        if not isinstance(self.micro_batches, list) or not self.micro_batches:
            raise ElasticityConfigError(
                f"'{ec.MICRO_BATCHES}' must be a non-empty list")
        if any((not isinstance(m, int)) or m <= 0 for m in self.micro_batches):
            raise ElasticityConfigError(
                f"'{ec.MICRO_BATCHES}' must contain positive ints, got "
                f"{self.micro_batches}")
        self.min_gpus = param_dict.get(ec.MIN_GPUS, ec.MIN_GPUS_DEFAULT)
        self.max_gpus = param_dict.get(ec.MAX_GPUS, ec.MAX_GPUS_DEFAULT)
        if self.min_gpus < 1 or self.max_gpus < self.min_gpus:
            raise ElasticityConfigError(
                f"invalid gpu range [{self.min_gpus}, {self.max_gpus}]")
        self.min_time = param_dict.get(ec.MIN_TIME, ec.MIN_TIME_DEFAULT)
        self.version = param_dict.get(ec.VERSION, ec.VERSION_DEFAULT)
        self.prefer_larger_batch_size = param_dict.get(
            ec.PREFER_LARGER_BATCH, ec.PREFER_LARGER_BATCH_DEFAULT)
        self.ignore_non_elastic_batch_info = param_dict.get(
            ec.IGNORE_NON_ELASTIC_BATCH_INFO, ec.IGNORE_NON_ELASTIC_BATCH_INFO_DEFAULT)

    def repr(self):
        return self.__dict__


# Highly composite numbers: batch sizes built from these divide evenly for
# many world sizes (same table idea as the reference; supports ~720K batch).
_HIGHLY_COMPOSITE = [
    1, 2, 4, 6, 12, 24, 36, 48, 60, 120, 180, 240, 360, 720, 840, 1260, 1680,
    2520, 5040, 7560, 10080, 15120, 20160, 25200, 27720, 45360, 50400, 55440,
    83160, 110880, 166320, 221760, 277200, 332640, 498960, 554400, 665280,
    720720,
]


def _candidate_batch_sizes(micro_batches, max_acceptable):
    """Largest micro*HCN <= max_acceptable, per micro batch size."""
    out = set()
    for m in micro_batches:
        best = m
        for h in _HIGHLY_COMPOSITE:
            if m * h > max_acceptable:
                break
            best = m * h
        out.add(best)
    return sorted(out)


def _valid_gpus(batch_size, micro_batches, min_gpus, max_gpus):
    """All world sizes g with batch_size == micro * acc * g for some micro in
    the list and integer acc >= 1 — i.e. divisors of batch_size/micro."""
    valid = set()
    for m in micro_batches:
        if batch_size % m:
            continue
        quotient = batch_size // m
        d = 1
        while d * d <= quotient:
            if quotient % d == 0:
                for g in (d, quotient // d):
                    if min_gpus <= g <= max_gpus:
                        valid.add(g)
            d += 1
    return sorted(valid)


def _best_candidate(candidates, micro_batches, min_gpus, max_gpus, prefer_larger):
    best_bs, best_valid = int(min(micro_batches)), []
    for bs in candidates:
        valid = _valid_gpus(bs, micro_batches, min_gpus, max_gpus)
        better_count = len(valid) > len(best_valid)
        tie_break = (len(valid) == len(best_valid) and
                     (bs > best_bs if prefer_larger else bs < best_bs))
        if better_count or tie_break:
            best_bs, best_valid = bs, valid
    return best_bs, best_valid


def _version_lt(a: str, b: str) -> bool:
    def parts(v):
        return [int(x) for x in str(v).split("+")[0].split(".")[:3]]

    return parts(a) < parts(b)


def get_compatible_gpus_v01(micro_batches, max_acceptable_batch_size,
                            min_gpus=1, max_gpus=None, prefer_larger=True):
    """v0.1 algorithm surface (reference elasticity.py:61-171)."""
    max_gpus = max_gpus or max_acceptable_batch_size // min(micro_batches)
    candidates = _candidate_batch_sizes(micro_batches, max_acceptable_batch_size)
    return _best_candidate(candidates, micro_batches, min_gpus, max_gpus,
                           prefer_larger)


def elasticity_enabled(ds_config: dict) -> bool:
    return ds_config.get(ec.ELASTICITY, {}).get(ec.ENABLED, ec.ENABLED_DEFAULT)


def ensure_immutable_elastic_config(runtime_elastic_config_dict):
    """Cross-restart immutability guard (reference elasticity.py:207-239):
    the scheduler pins the original elastic config in an env var; any
    divergence on restart would silently change convergence."""
    import json
    import os

    if ec.DEEPSPEED_ELASTICITY_CONFIG in os.environ:
        scheduler_config = json.loads(os.environ[ec.DEEPSPEED_ELASTICITY_CONFIG])
        scheduler = ElasticityConfig(scheduler_config)
        runtime = ElasticityConfig(runtime_elastic_config_dict)
        err = "Elastic config '{}={}' from the scheduler does not match the " \
              "runtime value '{}'"
        for key in ("max_acceptable_batch_size", "micro_batches", "min_gpus",
                    "max_gpus", "version"):
            if getattr(scheduler, key) != getattr(runtime, key):
                raise ElasticityConfigError(
                    err.format(key, getattr(scheduler, key), getattr(runtime, key)))


def compute_elastic_config(ds_config: dict, target_deepspeed_version: str = None,
                           world_size: int = 0):
    """Resolve (final_batch_size, valid_world_sizes[, micro_batch]) from an
    elastic config dict (reference elasticity.py:240-334)."""
    if not isinstance(ds_config, dict):
        raise ValueError("ds_config must be a dict")
    elastic_config_dict = ds_config.get(ec.ELASTICITY)
    if not elastic_config_dict:
        raise ElasticityConfigError(
            f"'{ec.ELASTICITY}' is missing from config json")
    elastic_config = ElasticityConfig(elastic_config_dict)
    if not elastic_config.enabled:
        raise ElasticityError(
            "Elasticity is not enabled; set 'elasticity': {'enabled': true, ...}")
    if float(elastic_config.version) > ec.LATEST_ELASTICITY_VERSION:
        raise ElasticityConfigError(
            f"Unsupported elasticity version {elastic_config.version}; latest is "
            f"{ec.LATEST_ELASTICITY_VERSION}")
    if target_deepspeed_version is not None and \
            _version_lt(target_deepspeed_version, ec.MINIMUM_DEEPSPEED_VERSION):
        raise ElasticityError(
            f"target version {target_deepspeed_version} is older than the "
            f"minimum elasticity-capable version {ec.MINIMUM_DEEPSPEED_VERSION}")

    final_batch_size, valid_gpus = get_compatible_gpus_v01(
        micro_batches=elastic_config.micro_batches,
        max_acceptable_batch_size=elastic_config.max_acceptable_batch_size,
        min_gpus=elastic_config.min_gpus,
        max_gpus=elastic_config.max_gpus,
        prefer_larger=elastic_config.prefer_larger_batch_size)
    logger.info(f"elasticity: final_batch_size={final_batch_size}, "
                f"valid world sizes={valid_gpus}")

    if world_size > 0:
        if world_size not in valid_gpus:
            raise ElasticityIncompatibleWorldSize(
                f"world size {world_size} is not in the valid set {valid_gpus}")
        # largest compatible micro batch for this world size
        candidates = [m for m in elastic_config.micro_batches
                      if final_batch_size % (m * world_size) == 0]
        if not candidates:
            raise ElasticityIncompatibleWorldSize(
                f"no micro batch in {elastic_config.micro_batches} divides "
                f"{final_batch_size} at world size {world_size}")
        micro_batch = max(candidates)
        return final_batch_size, valid_gpus, micro_batch

    return final_batch_size, valid_gpus
