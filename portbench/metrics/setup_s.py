"""Set-up seconds: from the start of the process's set-up (imports, the
card's context, loading the kernels, making the inputs) to the end of one
warm pass of the cell's own work."""


def read(rec):
    return rec["setup_s"]
