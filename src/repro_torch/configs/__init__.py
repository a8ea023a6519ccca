"""Config registry: all assigned architectures + paper-experiment configs."""
from repro_torch.configs.base import ArchConfig  # noqa: F401
from repro_torch.configs.registry import ARCHS, INPUT_SHAPES, get_arch, get_shape  # noqa: F401
