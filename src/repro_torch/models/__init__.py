"""Model zoo on torch tensors: the dense family so far (see ``model.py``)."""
from repro_torch.models.config import INPUT_SHAPES, InputShape, ModelConfig
from repro_torch.models.model import Model, build_model

__all__ = ["INPUT_SHAPES", "InputShape", "ModelConfig", "Model", "build_model"]
