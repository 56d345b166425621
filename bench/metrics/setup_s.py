"""setup_s: Set-up: process start to the first measured step (kernel
builds, weights, warm-up, the checked first steps)."""


def read(rec: dict):
    return rec["setup_s"]
