"""Loop and loader: the 95th percentile of the window's update times,
each the device clock's interval between the ends of consecutive updates
(CUDA events recorded after each update, read after the window's closing
synchronize): a stall of the loader or of the launch loop lengthens the
update it delays."""

import numpy as np


def read(ctx):
    ms = ctx["update_ms"]
    return float(np.percentile(ms, 95)) if ms else None
