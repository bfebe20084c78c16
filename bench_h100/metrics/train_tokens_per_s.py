"""train_tokens_per_s: the tokens of every training step dispatched in the
window, over the window, which ends on a device synchronise."""


def read(run: dict):
    if run.get("kind") != "train_batches":
        return None
    return run["train"]["tokens_per_s"]
