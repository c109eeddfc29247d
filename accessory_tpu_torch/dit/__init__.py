"""Large-DiT: LLaMA-style diffusion transformers (ImageNet class-conditional
and T2I). Port of ``accessory_tpu/dit``: the model (``model``), Gaussian
diffusion (``diffusion``), the timestep samplers (``timestep_sampler``) and
the training and sampling CLIs (``train``, ``sample``). No kernel of its
own: the products are ``torch.matmul``, attention the port's plain
non-causal attention, as the reference computes them outside any Pallas
kernel."""

from accessory_tpu_torch.dit.diffusion import GaussianDiffusion  # noqa: F401
from accessory_tpu_torch.dit.model import DiTArgs, dit_forward, dit_param_axes, init_dit  # noqa: F401
