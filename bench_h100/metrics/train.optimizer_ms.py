"""train.optimizer_ms: the device milliseconds of one torch.optim.Adam
step over the model's gradients, by CUDA events (median of several)."""


def read(run: dict):
    tr = run.get("train")
    return tr.get("optimizer_ms") if tr else None
