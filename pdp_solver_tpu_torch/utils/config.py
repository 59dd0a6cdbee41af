"""YAML model configs with the reference's key names and merge semantics.

Counterpart of `pdp_solver_tpu/utils/config.py`: a YAML model config and
the command line's arguments merge into one flat dict (last writer wins),
which `solvers.base.build_solver` reads, so the shipped `config/`
directory is read as it is. `yaml` is imported inside `load_yaml_config`
only: nothing else in the port needs PyYAML, and the card's machine may
lack it.
"""

KNOWN_MODEL_TYPES = ("np-nd-np", "p-nd-np", "np-d-np", "p-d-p", "walk-sat",
                     "reinforce")


def load_yaml_config(path):
    import yaml
    with open(path, "r") as f:
        return yaml.safe_load(f)


def merge_config(model_config: dict, args: dict) -> dict:
    """args override the YAML (reference `{**model_config, **args}`)."""
    return {**model_config, **args}


def apply_classical_overrides(config: dict) -> dict:
    """Reference satyr.py:92-101: classical solvers carry no weights and use
    hidden_dim=3 (the SP message width); walk-sat spends its whole iteration
    budget on local search."""
    config = dict(config)
    if config["model_type"] in ("p-d-p", "walk-sat", "reinforce"):
        config["model_path"] = None
        config["hidden_dim"] = 3
    if config["model_type"] == "walk-sat":
        config["local_search_iteration"] = config["test_recurrence_num"]
    config.setdefault("dropout", 0)
    config.setdefault("error_dim", 1)
    config.setdefault("exploration", 0)
    return config


def validate(config: dict):
    if config.get("model_type") not in KNOWN_MODEL_TYPES:
        raise ValueError(
            f"model_type must be one of {KNOWN_MODEL_TYPES}, "
            f"got {config.get('model_type')!r}")
    return config
