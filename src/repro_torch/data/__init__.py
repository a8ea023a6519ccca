from repro_torch.data.partition import PARTITIONERS, partition  # noqa: F401
from repro_torch.data.synthetic import (  # noqa: F401
    DATASETS,
    make_binary_classification,
)
