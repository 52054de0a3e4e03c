from .unet1d import AttentionBlock, UNet1D, unet_co, unet_msr, unet_nu, unet_topology
from .unet1d_fused import unet_apply_fn, unet_forward_cfg_pair, unet_forward_fused
