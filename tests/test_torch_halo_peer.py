"""A CPU model of K7's peer form (csrc/halo.cu, amg_halo_exchange_peer),
which runs only on the card: plain Python that follows the kernel's rules.

* The index map: the kernel's blocks, each putting one column chunk of one
  strip (into this process's receive strips, or into a neighbour's slot
  and then, by that neighbour, out of it), place every strip where
  ``launch.strips`` (on ``launch.edges``) places it, the plain version
  across processes; here the processes are threads on one emulated
  process group.
* The flags and epochs: under seeded random interleavings of P emulated
  processes, no receive slot is overwritten before its reader has read
  it, and every read sees its own epoch's strip; the kernel's epochs wrap
  at 2^32. Without the second slot the protocol fails; with one slot and
  the TPU kernel's barrier before the put it holds again.
"""

import random
import threading

import numpy as np
import pytest
import torch

from amg_tpu_torch.ops.kernels import halo
from amg_tpu_torch.ops.kernels.halo import (CHUNK, peer_layout,
                                            rdma_halo_exchange_peer,
                                            rdma_halo_exchange_plain)
from amg_tpu_torch.parallel import launch

# ---------------------------------------------------------------------------
# The index map.


def kernel_blocks(xs, G):
    """One launch of the peer kernel on every process: xs[p] is process
    p's (Dl, B, W) slabs. Each block (x, d, up) follows the kernel: local
    put, zero fill at the line's ends, or put into the neighbour's slot
    and signal; then the edge blocks wait for their flag and copy their
    slot chunk out. Returns each process's (Dl, 2G, W) strips and how
    often each of their elements was written."""
    P = len(xs)
    Dl, B, W = xs[0].shape
    chunks = -(-W // CHUNK)
    e, s = 1, 1                              # the first launch's epoch
    out = [np.full((Dl, 2 * G, W), np.nan) for _ in range(P)]
    writes = [np.zeros((Dl, 2 * G, W), int) for _ in range(P)]
    slots = [np.full((2, 2, G, W), np.nan) for _ in range(P)]
    flags = [np.zeros((2, chunks), np.int64) for _ in range(P)]
    blocks = [(p, x, d, up) for p in range(P) for x in range(chunks)
              for d in range(Dl) for up in (0, 1)]

    def fill(p, d, rows, cols, val):
        out[p][d, rows, cols] = val
        writes[p][d, rows, cols] += 1

    waits = []
    for p, x, d, up in blocks:
        cols = slice(x * CHUNK, min(W, (x + 1) * CHUNK))
        src = xs[p][d, :G, cols] if up else xs[p][d, B - G:, cols]
        edge = d == 0 if up else d == Dl - 1
        peer = p - 1 if up else p + 1
        # the strip this block fills: slab d-1's rows [G, 2G) or slab
        # d+1's rows [0, G); at an edge its own rows [0, G) or [G, 2G)
        to, rows = ((d - 1, slice(G, 2 * G)) if up
                    else (d + 1, slice(0, G)))
        if edge:
            to, rows = d, (slice(0, G) if up else slice(G, 2 * G))
        if not edge:
            fill(p, to, rows, cols, src)
        elif not 0 <= peer < P:
            fill(p, to, rows, cols, 0.0)
        else:
            there, here = up, 1 - up
            slots[peer][s, there, :, cols] = src
            flags[peer][there, x] = e
            waits.append((p, x, to, rows, cols, here))
    for p, x, to, rows, cols, here in waits:
        assert flags[p][here, x] >= e
        fill(p, to, rows, cols, slots[p][s, here, :, cols])
    return out, writes


class FakeGroup:
    """The point-to-point calls ``launch.edges`` makes, between threads:
    each thread is a rank; a batch posts its sends, then takes its
    receives as they arrive."""

    isend, irecv = "isend", "irecv"

    def __init__(self):
        self.local = threading.local()
        self.box = {}
        self.cv = threading.Condition()

    def rank(self) -> int:
        return self.local.rank

    @staticmethod
    def P2POp(op, tensor, peer, tag=0):
        return op, tensor, peer, tag

    def batch_isend_irecv(self, ops):
        me = self.rank()
        with self.cv:
            for op, t, peer, tag in ops:
                if op == self.isend:
                    self.box[(me, peer, tag)] = t.clone()
            self.cv.notify_all()
        for op, t, peer, tag in ops:
            if op == self.irecv:
                with self.cv:
                    assert self.cv.wait_for(
                        lambda: (peer, me, tag) in self.box, timeout=30)
                    t.copy_(self.box.pop((peer, me, tag)))
        return []


def edges_exchange(monkeypatch, xs, G):
    """``launch.strips`` of each process's slabs, P threads
    on one emulated process group (``launch.edges``'s send/recv)."""
    P = len(xs)
    fake = FakeGroup()
    monkeypatch.setattr(launch, "dist", fake)
    monkeypatch.setattr(launch, "process_count", lambda: P)
    monkeypatch.setattr(launch, "process_index", fake.rank)
    monkeypatch.setattr(launch, "_gloo_staged", lambda: False)
    got, errors = [None] * P, []

    def run(p):
        fake.local.rank = p
        try:
            got[p] = launch.strips(torch.from_numpy(xs[p]), G)
        except Exception as exc:   # re-raised by the test below
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(p,)) for p in range(P)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    if errors:
        raise errors[0]
    return [g.numpy() for g in got]


@pytest.mark.parametrize("Dl", [1, 2, 4])
@pytest.mark.parametrize("P", [1, 2, 4])
def test_index_map_is_edges(monkeypatch, P, Dl):
    """Every element of every process's strips is written once, by the
    block the kernel's rules name, and holds what launch.edges puts there;
    both equal the one-process exchange of the whole line. The values are
    their own global row and column, so a misplaced strip shows. Three
    column chunks (one ragged), G < B and G == B."""
    W = 2 * CHUNK + 77
    for B, G in ((6, 3), (4, 4)):
        D = P * Dl
        rows = np.arange(D * B, dtype=np.float64)[:, None]
        field = (rows * W + np.arange(W) + 1).reshape(D, B, W)
        xs = [field[p * Dl:(p + 1) * Dl] for p in range(P)]
        got, writes = kernel_blocks(xs, G)
        want = edges_exchange(monkeypatch, xs, G)
        whole = rdma_halo_exchange_plain(torch.from_numpy(field), G).numpy()
        for p in range(P):
            assert (writes[p] == 1).all(), (P, Dl, p)
            np.testing.assert_array_equal(got[p], want[p])
            np.testing.assert_array_equal(want[p],
                                          whole[p * Dl:(p + 1) * Dl])


def test_wrapper_on_cpu_is_the_plain_version():
    """On CPU tensors the peer form needs no strips and launches nothing."""
    rng = np.random.default_rng(0)
    u, b = (torch.from_numpy(rng.standard_normal((3, 8, 5)))
            for _ in range(2))
    halo.rdma_halo_exchange.launches = 0
    got = rdma_halo_exchange_peer((u, b), 4)
    assert torch.equal(got, rdma_halo_exchange_plain((u, b), 4))
    assert halo.rdma_halo_exchange.launches == 0
    with pytest.raises(ValueError, match="1 <= G <= B"):
        rdma_halo_exchange_peer(u, 9)


@pytest.mark.parametrize("D,G,W,es", [(2, 10, 8190, 4), (1, 10, 8190, 8),
                                      (4, 3, 257, 4), (8, 1, 1, 8)])
def test_layout(D, G, W, es):
    """The out strips, the two epochs' slots and the flags do not overlap,
    each starts on a 256-byte boundary, and there is one flag a column
    chunk and side, then the epoch and the block count."""
    lay = peer_layout(D, G, W, es)
    assert lay["out"] == 0 and lay["chunks"] == -(-W // CHUNK)
    assert lay["slots"] >= D * 2 * G * W * es
    assert lay["flags"] >= lay["slots"] + 2 * 2 * G * W * es
    assert lay["slots"] % 256 == 0 and lay["flags"] % 256 == 0
    assert lay["nbytes"] == lay["flags"] + 4 * (2 * lay["chunks"] + 2)


# ---------------------------------------------------------------------------
# The flags and epochs.

MASK = (1 << 32) - 1


def reached(f: int, e: int) -> bool:
    """(int)(f - e) >= 0 on 32-bit words, as the kernel compares."""
    return ((f - e) & MASK) < (1 << 31)


class Violation(Exception):
    pass


def run_protocol(P: int, launches: int, seed: int, n_slots: int = 2,
                 barrier: bool = False, start: int = 0) -> int:
    """P processes, each ``launches`` K7 launches in stream order, under one
    seeded random interleaving of every block's steps. A launch's edge
    blocks with a neighbour run, each in order: [barrier: signal ready to
    the neighbour, wait for its ready], put the strip into the neighbour's
    slot (epoch & 1, or 0 with one slot), signal its flag, wait for the
    own flag of the other side, copy the own slot out. A process's next
    launch starts when every block of the last one is done. The epoch
    counter starts at ``start``. Raises Violation on a slot overwritten
    before its reader read it, a read of another epoch's strip or a
    deadlock; returns the steps taken."""
    rng = random.Random(seed)
    flags = [[start, start] for _ in range(P)]        # [side]
    ready = [[start, start] for _ in range(P)]
    slots = [[[None, None] for _ in range(n_slots)] for _ in range(P)]
    done = [0] * P
    counter = [start] * P
    progs = [None] * P

    def blocks(p):
        e = (counter[p] + 1) & MASK
        s = e & 1 if n_slots == 2 else 0
        out = []
        for up in (1, 0):
            peer = p - 1 if up else p + 1
            if 0 <= peer < P:
                out.append(block(p, peer, up, e, s))
        return out

    def block(p, peer, up, e, s):
        there, here = up, 1 - up
        if barrier:
            ready[peer][there] = e
            yield lambda: reached(ready[p][here], e)
        slot = slots[peer][s]
        if slot[there] is not None and not slot[there][2]:
            raise Violation(f"process {p} overwrote process {peer}'s slot "
                            f"{s} (epoch {slot[there][1]} unread) at "
                            f"epoch {e}")
        slot[there] = [p, e, False]
        yield None
        flags[peer][there] = e
        yield lambda: reached(flags[p][here], e)
        got = slots[p][s][here]
        if got is None or got[0] != peer or got[1] != e:
            raise Violation(f"process {p} read {got} at epoch {e}, not "
                            f"process {peer}'s")
        got[2] = True

    steps = 0
    while True:
        for p in range(P):
            if progs[p] is not None and not progs[p]:
                counter[p] = (counter[p] + 1) & MASK   # the last block
                done[p] += 1
                progs[p] = None
            if progs[p] is None and done[p] < launches:
                progs[p] = [[b, None] for b in blocks(p)]
        runnable = [(p, i) for p in range(P) if progs[p]
                    for i, (b, cond) in enumerate(progs[p])
                    if cond is None or cond()]
        if not runnable:
            if all(d == launches for d in done):
                return steps
            raise Violation(f"deadlock after {steps} steps: {done}")
        p, i = rng.choice(runnable)
        b = progs[p][i]
        try:
            b[1] = next(b[0])
        except StopIteration:
            progs[p].pop(i)
        steps += 1


@pytest.mark.parametrize("P", [2, 3, 4])
@pytest.mark.parametrize("start", [0, MASK - 4])
def test_protocol_holds(P, start):
    """The kernel's protocol, two slots by epoch parity and no barrier:
    every interleaving tried keeps every slot until it is read and every
    read on its own epoch, also across the epoch counter's wrap."""
    steps = sum(run_protocol(P, 40, seed, start=start)
                for seed in range(25))
    assert steps > 3000


@pytest.mark.parametrize("P", [2, 4])
def test_protocol_needs_its_second_slot(P):
    """With one slot and no barrier a put can overwrite a strip its reader
    has not read yet: some interleaving shows it."""
    failures = 0
    for seed in range(25):
        try:
            run_protocol(P, 40, seed, n_slots=1)
        except Violation as exc:
            assert "overwrote" in str(exc) or "read" in str(exc)
            failures += 1
    assert failures > 0


@pytest.mark.parametrize("P", [2, 4])
def test_one_slot_needs_the_barrier(P):
    """One slot with the TPU kernel's barrier before the put (both
    neighbours ready) holds: the second slot stands in for that barrier."""
    for seed in range(25):
        run_protocol(P, 40, seed, n_slots=1, barrier=True)
