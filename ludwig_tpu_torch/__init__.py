"""ludwig_tpu_torch: the PyTorch + CUDA port of ludwig_tpu.

A second package beside the JAX one, which stays the reference.  Plain
tensor code is PyTorch on a device (the GPU unless the caller asks for
the CPU); the fused collide+stream kernels (with and without bounce-back
on solid sites, with and without isothermal fluctuations), the binary
fluid's order-parameter kernel, the liquid crystal's Q-tensor kernel,
the LC droplet's coupled phi + Q kernel, the electrokinetic SOR and
Nernst-Planck kernels and the reference-ordered statistics scans are
hand-written CUDA for Hopper (csrc/*.cu), each with a plain twin that
the CPU takes.  This package imports neither JAX nor ludwig_tpu.
"""

__version__ = "0.1.0"

from ludwig_tpu_torch.lattice import LatticeModel, lb_model, model_from_name
from ludwig_tpu_torch.lb import (LBConfig, initial_from_hydro, initial_rest,
                                 make_step)
from ludwig_tpu_torch.noise import NoiseConfig
from ludwig_tpu_torch.ops.collide import (CollisionParams, RelaxationScheme,
                                          collide, equilibrium)
from ludwig_tpu_torch.ops.stream import stream, stream_bounce_back
from ludwig_tpu_torch.runtime import RunTime
