"""Every replica-scan the window completed over the window's seconds: from
the first call's dispatch (its trial's initialisation) to the last call's
read-back, trial re-initialisations included."""


def read(run):
    return run.window.replica_scans / run.window.seconds
