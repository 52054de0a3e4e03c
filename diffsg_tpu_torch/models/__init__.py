from .unet1d import UNet1D, unet_co, unet_msr, unet_nu, unet_topology
from .unet1d_fused import unet_apply_fn, unet_forward_fused
