"""The 95th percentile (numpy's linear interpolation) over every call of
the window of the host wall time from a call's dispatch (its packet's
upload) until its replicas' poses and match counts are on the host.  Only
where a call is one fleet step."""

import numpy as np


def read(run):
    if run.window.scans_per_call != 1 or not run.window.call_ms:
        return None
    return float(np.percentile(np.asarray(run.window.call_ms), 95))
