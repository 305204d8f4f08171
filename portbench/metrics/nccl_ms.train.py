"""nccl_ms.train: NCCL's device time a step on rank 0 in the traced
window's ``_train`` call, in ms: every kernel whose name holds "nccl"
(the gradient's sum, each BatchNorm's sums forward and backward, the log
point's gathers), its seconds in rank 0's trace over the window's steps.
A kernel of NCCL runs from its launch until every rank has joined, so the
time holds the wait for the slowest rank as well as the transfer.  A cell
on one card runs no NCCL kernel and reads nothing.  Moves
train_frames_per_s."""


def read(r):
    if r.kind != "train" or r.trace is None or not r.traced_window:
        return None
    seconds = sum(s for name, (s, _) in r.trace["kernels"].items() if "nccl" in name.lower())
    steps = r.traced_window.get("steps")
    if seconds <= 0 or not steps:
        return None
    return 1e3 * seconds / steps
