"""The program under test, built from a cell's configuration: the only
place the harness constructs the port's model."""

from __future__ import annotations

from portbench.harness import weights


def _model_config(cell, step: float):
    from repro_torch.configs.base import DslotConfig, ModelConfig
    m = {k: tuple(v) if isinstance(v, list) else v
         for k, v in cell.config["model"].items()}
    return ModelConfig(**m, dslot=DslotConfig(enabled=True, act_scale=step,
                                              **cell.config["dslot"]))


def setup_model(cell, seed: int, device):
    """The cell's weights from the seed, the calibrated DSLOT step, and the
    port's model."""
    import torch
    from repro_torch.models.model_zoo import build_model
    model_d = cell.config["model"]
    params = weights.draw_params(model_d, seed, device)
    step = weights.calibrate_step(params, model_d, seed, device,
                                  int(cell.config["dslot"]["n_bits"]),
                                  **cell.config["calibration"])
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    return params, step, build_model(_model_config(cell, step))
