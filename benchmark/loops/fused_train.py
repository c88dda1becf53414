"""One booster trained chunk after chunk of fused iterations
(``Booster.update_chunked``, the driving ``engine.train`` gives a run
without per-iteration callbacks) until the window ends.

The program reads each chunk's records one chunk late (its stall
check), so one chunk is the most work queued on the card while the host
waits: a host that stands still for longer leaves the card idle.

Set-up bins the rows on the card and runs the first chunk through the
window's own call, which builds and captures (at the chunk's length: a
longer one would reallocate and capture again).  ``judged_chunks``
consecutive chunks of the window, the first drawn from the seed among
its first ``sample_among`` (of a traced run, the traced chunk and those
after it), are judged: the program's training scores are copied on the
card before each and after the last, and after the window the reference
follows each chunk's first tree from the program's own scores before it
and walks every tree to the scores after the last.
"""

from __future__ import annotations

import time

import torch

from .. import compare
from . import Base, plain_trees


class Loop(Base):
    def setup(self) -> None:
        import lightgbm_tpu_torch as lt
        self.x, self.y = self.rows(0, self.cfg["train_rows"])
        self.chunk = int(self.mix["chunk"])
        ds = lt.Dataset(self.x, label=self.y.cpu().numpy(),
                        params=self.params())
        self.booster = lt.Booster(params=self.params(), train_set=ds)
        self.judge_at, self.starts, self.end = None, [], None
        self.chunks = 0
        self.step()
        self.codes = ds._handle.binned
        self.chunks = 0
        self.sync()

    def judged_done(self) -> bool:
        return self.end is not None

    def step(self) -> int:
        """One chunk; the iterations it ran.  The chunks ``judge_at``
        onwards (counted from the first after set-up) are judged."""
        gb = self.booster._gbdt
        j = -1 if self.judge_at is None else self.chunks - self.judge_at
        n = int(self.mix["judged_chunks"])
        if 0 <= j < n:
            self.starts.append((len(gb.models), gb.train_score[0].clone()))
        if self.booster.update_chunked(self.chunk, self.chunk):
            raise RuntimeError("training stopped: no leaf could be split")
        if j == n - 1:
            self.end = gb.train_score[0].clone()
        self.chunks += 1
        return self.chunk

    def window(self, seconds: float):
        self.judge_at = self.draw(self.mix["sample_among"])
        self.sync()
        t0 = time.perf_counter()
        it = 0
        waits = []
        # a window shorter than the judged chunks runs on until they are
        # done (at the cell's length they come in its first seconds)
        while time.perf_counter() - t0 < seconds or not self.judged_done():
            t = time.perf_counter()
            it += self.step()
            waits.append(time.perf_counter() - t)
        self.sync()
        dt = time.perf_counter() - t0
        self.ctx.log(f"window: {len(waits)} chunks in {dt:.3f} s; a chunk's "
                     f"call {min(waits):.3f} to {max(waits):.3f} s")
        self.attempted += it
        return {self.mix["metric"]: it / dt}

    def traced(self, profiler):
        from lightgbm_tpu_torch.ops import hist_cuda
        steps = int(self.mix["trace_steps"])
        self.judge_at = 0
        gb = self.booster._gbdt
        n0, s0 = len(gb.models), len(gb._stats)
        hist_cuda.wave_hist.launches.reset()
        with profiler:
            with torch.profiler.record_function("bench.window"):
                t0 = time.perf_counter()
                it = sum(self.step() for _ in range(steps))
                self.sync()
                wall = time.perf_counter() - t0
        launches = hist_cuda.wave_hist.launches.read()
        while not self.judged_done():
            it += self.step()
        self.attempted += it
        gb._flush_pending()
        stats = gb.tree_stats[s0:s0 + steps]
        grower = gb._grower
        traced = steps * self.chunk
        return dict(trace=profiler.trace, iters=traced, wall_s=wall,
                    trees=gb.models[n0:n0 + traced],
                    waves=sum(s[2] for s in stats),
                    syncs=sum(s[3] for s in stats),
                    wave_launches=launches,
                    rows=gb.num_data, groups=gb.train_set.num_groups,
                    features=gb.train_set.num_features,
                    k=grower.hist_cols if grower is not None else 3)

    def drop(self) -> None:
        self.booster.num_trees()
        last = self.starts[-1][0] + self.chunk
        self.trees = plain_trees(self.booster._gbdt.models[:last])
        self.starts = [(f, st.cpu()) for f, st in self.starts]
        self.end = self.end.cpu()
        self.codes = self.codes.cpu()
        self.booster = None

    def check(self):
        log = self.ctx.log
        log("judged: the first trees of chunks "
            f"{[f // self.chunk for f, _ in self.starts]} (trees "
            f"{[f + 1 for f, _ in self.starts]})")
        p = self.judge_params()
        mism, bins = compare.codes_mismatch(self.x, self.codes, p, log)
        out = compare.judge_trees(self.x, self.y, p, bins, self.objective(),
                                  self.trees, self.starts, 1, self.end, log)
        return [("codes_mismatch", mism)] + list(out.items())
