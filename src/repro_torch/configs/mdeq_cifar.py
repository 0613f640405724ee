"""The paper's own model: a multiscale DEQ for CIFAR-scale image
classification (Bai et al. 2020 setting, paper §3.2), the port's copy of
``repro/configs/mdeq_cifar.py``: two scales at CIFAR's 32 x 32, Broyden
forward, SHINE-family backward."""

import dataclasses


@dataclasses.dataclass(frozen=True)
class MDEQConfig:
    image_size: int = 32
    channels: tuple = (24, 48)     # two scales (the paper uses 4 at d=50k)
    num_classes: int = 10
    groups: int = 8                # group-norm groups
    max_steps: int = 18
    tol: float = 1e-3
    memory: int = 18
    backward: str = "shine"
    refine_steps: int = 5
    backward_max_steps: int = 24
    solver: str = "broyden"


CONFIG = MDEQConfig()
