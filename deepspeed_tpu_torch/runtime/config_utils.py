"""Config parsing helpers — the port's copy of
deepspeed_tpu/runtime/config_utils.py (reference:
deepspeed/runtime/config_utils.py)."""

import json
from collections import Counter


def get_scalar_param(param_dict, param_name, param_default_value):
    return param_dict.get(param_name, param_default_value)


def get_list_param(param_dict, param_name, param_default_value):
    return param_dict.get(param_name, param_default_value)


def get_dict_param(param_dict, param_name, param_default_value):
    return param_dict.get(param_name, param_default_value)


def dict_raise_error_on_duplicate_keys(ordered_pairs):
    """json object_pairs_hook that rejects duplicate keys (reference
    config_utils.py dict_raise_error_on_duplicate_keys)."""
    d = dict(ordered_pairs)
    if len(d) != len(ordered_pairs):
        counter = Counter([pair[0] for pair in ordered_pairs])
        keys = [key for key, value in counter.items() if value > 1]
        raise ValueError(f"Duplicate keys in DeepSpeed config: {keys}")
    return d


class ScientificNotationEncoder(json.JSONEncoder):
    """Emit large/small floats in scientific notation for readable dumps
    (reference config_utils.py ScientificNotationEncoder)."""

    def iterencode(self, o, _one_shot=False):
        return super().iterencode(self._transform(o), _one_shot=_one_shot)

    def _transform(self, o):
        if isinstance(o, float) and (abs(o) >= 1e3 or (0 < abs(o) < 1e-3)):
            return _SciFloat(o)
        if isinstance(o, dict):
            return {k: self._transform(v) for k, v in o.items()}
        if isinstance(o, (list, tuple)):
            return [self._transform(v) for v in o]
        return o


class _SciFloat(float):
    def __repr__(self):
        return f"{float(self):e}"


class DeepSpeedConfigObject:
    """repr-able config holder (reference config_utils.py)."""

    def repr(self):
        return self.__dict__

    def __repr__(self):
        return json.dumps(self.__dict__, sort_keys=True, indent=4,
                          cls=ScientificNotationEncoder, default=repr)
