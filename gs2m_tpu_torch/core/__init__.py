from gs2m_tpu_torch.core.camera import Camera
from gs2m_tpu_torch.core.config import ModelConfig, OptimConfig, PipelineConfig
from gs2m_tpu_torch.core.gaussians import Gaussians

__all__ = ["Camera", "Gaussians", "ModelConfig", "PipelineConfig", "OptimConfig"]
