"""Real residues embedded and searched, over the window's time from its
start to the end of its last completed call."""


def read(run):
    if "residues" not in run.calls[0]:
        return None
    return run.total("residues") / run.window_s()
