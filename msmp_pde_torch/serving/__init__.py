"""Bucketed rollout engine, AOT export and HTTP server (counterpart of
msmp_pde_tpu/serving). The names below load on first use, so that loading
an exported rollout (``serving.export``) imports no model code."""
import importlib

_NAMES = {"RolloutEngine": "engine", "RolloutProgram": "engine",
          "build_serving_trainer": "engine", "grid_from_h5": "engine",
          "export_rollout": "export", "load_exported": "export"}


def __getattr__(name):
    if name in _NAMES:
        module = importlib.import_module(
            f"msmp_pde_torch.serving.{_NAMES[name]}")
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
