"""The plain reference of the benchmark's configurations: the UNet1D net
(``unet``), the samplers (``sampler``) and one module per task, named as the
task, with its conditions and its decoder. It imports nothing of the served
program."""
