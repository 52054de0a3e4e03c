"""kernels_per_request.online: device kernels (copies and sets aside) in the
traced span over the requests in it."""


def read(run):
    p = run.profile
    if p is None or p.kernels == 0:
        return None
    return p.kernels / p.requests
