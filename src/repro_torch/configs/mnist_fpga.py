"""The paper's own network: 784-500-10 feed-forward MNIST classifier
(Adiletta & Flanagan 2020). Counterpart of `repro/configs/mnist_fpga.py`:
imported by the registry but, as in the reference, left out of `ARCHS`;
its pipeline lives in `repro_torch.core` (training, the quantization
ladder, netgen)."""
from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    name="mnist-fpga",
    family="mlp",           # handled by repro_torch.core, not the LM runtime
    n_layers=2,
    d_model=500,            # hidden width
    vocab=10,               # output classes
)
