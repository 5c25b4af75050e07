"""PWCDCNet, the legacy PWCNet, RAFT, GMFlow, GMA and their parts in PyTorch."""

from pwcnet_tpu_torch.models.context import ContextNetwork
from pwcnet_tpu_torch.models.estimator import FlowEstimator, FlowEstimatorLegacy
from pwcnet_tpu_torch.models.gma import GMA
from pwcnet_tpu_torch.models.gmflow import GMFlow
from pwcnet_tpu_torch.models.pwcnet import PWCDCNet, PWCNet, flow_scales
from pwcnet_tpu_torch.models.pyramid import FeaturePyramidExtractor, FeaturePyramidExtractorLegacy
from pwcnet_tpu_torch.models.raft import RAFT

__all__ = [
    "ContextNetwork", "FeaturePyramidExtractor", "FeaturePyramidExtractorLegacy", "FlowEstimator",
    "FlowEstimatorLegacy", "GMA", "GMFlow", "PWCDCNet", "PWCNet", "RAFT", "flow_scales",
]
