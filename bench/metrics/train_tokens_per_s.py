"""train_tokens_per_s: Every token of the window's training steps over the
time from the window's start to the synchronised end of its last step."""


def read(rec: dict):
    if rec["kind"] != "train":
        return None
    return rec["tokens"] / rec["window_s"]
