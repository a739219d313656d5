"""Three-term roofline of the port: hardware models and per-device op costs."""

from repro_torch.roofline.analysis import (
    H100_SXM,
    V5E,
    HardwareModel,
    RooflineTerms,
    model_flops,
    roofline_from_cell,
)

__all__ = ["RooflineTerms", "V5E", "H100_SXM", "HardwareModel", "roofline_from_cell",
           "model_flops"]
