"""The plain reference of the benchmark's configurations: the UNet1D net
(``unet``), the samplers (``sampler``), the condition layout of a multi-task
face (``faces``) and one module per task, named as the task, with its
conditions and its decoder. It imports nothing of the served program."""
