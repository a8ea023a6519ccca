from repro_torch.data.partition import (  # noqa: F401
    PARTITIONERS,
    heterogeneity_score,
    partition,
)
from repro_torch.data.synthetic import (  # noqa: F401
    DATASETS,
    make_binary_classification,
    make_lm_tokens,
    make_mnist_like,
)
