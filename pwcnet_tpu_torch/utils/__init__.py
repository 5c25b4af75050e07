"""I/O, visualization and experiment utilities (numpy only; ``profiling``
imports torch and is not imported here)."""

from pwcnet_tpu_torch.utils.config import ExperimentSaver, save_config, show_progress, timestamp
from pwcnet_tpu_torch.utils.flo_io import FLO_MAGIC, load_flow, save_flow
from pwcnet_tpu_torch.utils.flow_viz import flow_to_color, make_colorwheel, vis_flow, vis_flow_pyramid

__all__ = [
    "ExperimentSaver", "save_config", "show_progress", "timestamp",
    "FLO_MAGIC", "load_flow", "save_flow",
    "flow_to_color", "make_colorwheel", "vis_flow", "vis_flow_pyramid",
]
