from repro_torch.data.synth import (  # noqa: F401
    SynthSpec,
    HAPT_LIKE,
    MNIST_HOG_LIKE,
    make_dataset,
)
from repro_torch.data.partition import (  # noqa: F401
    partition_uniform,
    partition_class_unbalanced,
    partition_node_unbalanced,
    LocationShards,
)
