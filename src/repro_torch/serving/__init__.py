from repro_torch.serving.request import Request, RequestOutput, RequestPhase
from repro_torch.serving.engine import ServingEngine, ServingConfig
from repro_torch.serving.scheduler import ContinuousScheduler

__all__ = ["Request", "RequestOutput", "RequestPhase", "ServingEngine",
           "ServingConfig", "ContinuousScheduler"]
