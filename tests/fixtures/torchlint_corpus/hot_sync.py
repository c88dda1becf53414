"""TL001 fixture: host-device syncs planted inside hot-path loops.

Each ``# PLANT: TLxxx`` marks one defect the analyzer must report
exactly once; unmarked code is clean by construction and must stay
silent (tests/test_torch_lint.py enforces both directions).
"""
# torchlint: hot-path

import numpy as np
import torch


def per_iteration_item(trees):
    total = 0.0
    for t in trees:
        total += t.value.item()  # PLANT: TL001
    return total


def int_of_tensor_value(n):
    scores = torch.zeros((n,))
    out = []
    for i in range(n):
        out.append(int(scores.sum()))  # PLANT: TL001
    return out


def copy_back_each_round(rounds, dev):
    leaf = torch.zeros(8, device=dev)
    host = []
    for _ in range(rounds):
        host.append(leaf.cpu().numpy())  # PLANT: TL001
    return host


def control_word_in_while(st):
    ctl = st.ctl
    while int(ctl[1]) == 0:  # PLANT: TL001
        st.step()


def synchronize_per_tree(trees):
    for t in trees:
        t.grow()
        torch.cuda.synchronize()  # PLANT: TL001


def event_wait_per_tree(trees, ev):
    for t in trees:
        t.grow()
        ev.synchronize()  # PLANT: TL001


def asarray_of_tensor(n):
    x = torch.ones((4,))
    return [np.asarray(x) for _ in range(n)]  # PLANT: TL001


def tolist_in_comprehension(handles):
    return [h.tolist() for h in handles]  # PLANT: TL001


def numpy_scalar_read_is_clean(gains):
    host = np.asarray(gains, np.float64)
    top = []
    for f in range(host.shape[0]):
        top.append(float(host[f]))      # numpy: host memory, no sync
        top.append(host[f].item())      # numpy's item()
    return top


def host_tensor_numpy_is_clean(pinned):
    # .numpy() only accepts a tensor already on the host
    return tuple(h.numpy() for h in pinned)


def metadata_reads_are_clean(n):
    x = torch.ones((n, 4))
    dims = []
    for _ in range(3):
        dims.append(int(x.shape[0]) + int(x.numel()))
    return dims


def one_read_after_the_loop(trees):
    leaves = torch.zeros(len(trees))
    for i, t in enumerate(trees):
        leaves[i] = t.leaf_count
    return leaves.cpu().numpy()     # once, outside the loop


def suppressed_variant(st):
    for _ in range(3):
        # torchlint: disable-next=TL001 -- a plain per-wave read, by design
        st.n = int(st.ctl[0])
