"""The paper's own evaluation network (Fig. 6): MNIST CNN, conv 5x5 + ReLU +
2x2 maxpool accelerated by DSLOT-NN, trained WITHOUT bias terms (paper §III-A
attributes its 12.5% negative-activation rate partly to the missing biases).
A copy of ``repro.configs.dslot_mnist``.
"""

from dataclasses import dataclass


@dataclass(frozen=True)
class MnistCNNConfig:
    name: str = "dslot-mnist-cnn"
    image_size: int = 28
    kernel_size: int = 5           # k=5 -> 25 OLMs per PE (paper config)
    conv_channels: int = 8
    n_classes: int = 10
    use_bias: bool = False         # paper: trained without bias
    n_bits: int = 8                # 8-bit fixed point operands
    pool: int = 2                  # 2x2 maxpool -> 4 PEs per pooling window


CONFIG = MnistCNNConfig()
