from repro_torch.core.engine import SpecPVEngine, EngineState

__all__ = ["SpecPVEngine", "EngineState"]
