"""Optical-flow models of the port (``vsrlab_tpu/models/flow``): RAFT
(small and basic) with its reference-checkpoint loader, IRR-PWC, and the
progressive SpyNet of the curriculum trainer with its level sizes."""

from vsrlab_tpu_torch.models.flow.irr import IRRPWCNet
from vsrlab_tpu_torch.models.flow.raft import RAFT, load_raft_state_dict
from vsrlab_tpu_torch.models.flow.spynet_progressive import MAX_G, GConf, SpyNetProgressive

__all__ = ["GConf", "IRRPWCNet", "MAX_G", "RAFT", "SpyNetProgressive", "load_raft_state_dict"]
