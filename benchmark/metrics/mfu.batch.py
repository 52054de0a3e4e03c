"""mfu.batch: the whole window's share of the device's float32 peak: the
Dense operations of the solutions answered in the window
(``counts.request_flops``) over the window's seconds on the host clock
times ``counts.PEAK_F32_FLOPS``, in percent. Every cost of the served path,
on the host or the device, moves it as it moves ``solutions_per_s``; it
bounds the kernels' roofline shares and locates no layer."""

from benchmark.metrics import counts


def read(run):
    flops = sum(counts.request_flops(run.config["model"], run.config["sampler"], d.rows)
                for d in run.done if d.ok)
    return 100.0 * flops / (run.window_s * counts.PEAK_F32_FLOPS)
