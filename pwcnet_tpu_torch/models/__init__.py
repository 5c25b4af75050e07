"""PWCDCNet and its parts in PyTorch."""

from pwcnet_tpu_torch.models.context import ContextNetwork
from pwcnet_tpu_torch.models.estimator import FlowEstimator
from pwcnet_tpu_torch.models.pwcnet import PWCDCNet, flow_scales
from pwcnet_tpu_torch.models.pyramid import FeaturePyramidExtractor

__all__ = ["ContextNetwork", "FeaturePyramidExtractor", "FlowEstimator", "PWCDCNet", "flow_scales"]
