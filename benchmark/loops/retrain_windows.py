"""The fork's retrain-every-window pattern: each window a fresh
``Dataset`` over the window's rows on the card (bins found anew) and a
fresh booster trained ``rounds`` iterations by ``engine.train``; the
loop cycles through ``windows`` windows made in set-up.  Set-up trains
one warm window first, so later windows adopt the grower cache's
captured graphs.

One window of the timed loop, drawn from the seed among the first
``sample_among``, is judged: its codes, its first ``ref_trees`` trees
against the reference's (bagging and feature_fraction worked out
again) and its training scores against its own trees."""

from __future__ import annotations

import time

import torch

from .. import compare
from . import Base, plain_trees


class Loop(Base):
    def setup(self) -> None:
        c = self.cfg
        self.rounds = int(self.mix["rounds"])
        self.windows = []
        for i in range(int(self.mix["windows"])):
            x, y = self.rows(10 + i, c["train_rows"], index=i,
                             drift=float(c.get("drift", 0.0)))
            self.windows.append((x, y.cpu().numpy()))
        self.sample = self.draw(self.mix["sample_among"])
        self.judged = None
        self.bin_s = []
        self.train_one(0)
        self.sync()

    def train_one(self, i: int):
        """Window ``i``: bin its rows, train, return the booster."""
        import lightgbm_tpu_torch as lt
        x, y = self.windows[i % len(self.windows)]
        t0 = time.perf_counter()
        ds = lt.Dataset(x, label=y, params=self.params()).construct()
        self.sync()
        self.bin_s.append(time.perf_counter() - t0)
        booster = lt.train(self.params(), ds, num_boost_round=self.rounds,
                           verbose_eval=False)
        return ds, booster

    def window(self, seconds: float):
        self.sync()
        t0 = time.perf_counter()
        done, end = 0, t0
        # a window shorter than the judged window runs on until it is
        # done (at the cell's length it comes in its first seconds)
        while time.perf_counter() - t0 < seconds or done <= self.sample:
            ds, booster = self.train_one(done)
            if done == self.sample:
                # judged after the window: the booster lets go of its
                # grower, as a freed booster does, for the next window
                booster._gbdt.release_grower()
                self.judged = dict(index=done, ds=ds, booster=booster)
            del ds, booster
            self.sync()
            done += 1
            end = time.perf_counter()
        self.attempted += done
        return {"window_s": (end - t0) / done}

    def traced(self, profiler):
        from lightgbm_tpu_torch.ops import hist_cuda
        hist_cuda.wave_hist.launches.reset()
        n0 = len(self.bin_s)
        i = int(self.mix["sample_among"])
        with profiler:
            with torch.profiler.record_function("bench.window"):
                t0 = time.perf_counter()
                ds, booster = self.train_one(i)
                self.sync()
                wall = time.perf_counter() - t0
        self.attempted += 1
        gb = booster._gbdt
        gb._flush_pending()
        stats = gb.tree_stats
        grower = gb._grower
        out = dict(trace=profiler.trace, iters=len(gb.models), wall_s=wall,
                   trees=list(gb.models), windows=1,
                   waves=sum(s[2] for s in stats),
                   syncs=sum(s[3] for s in stats),
                   wave_launches=hist_cuda.wave_hist.launches.read(),
                   rows=gb.num_data, groups=ds._handle.num_groups,
                   features=ds._handle.num_features,
                   columns=int(self.windows[0][0].shape[1]),
                   k=grower.hist_cols if grower is not None else 3,
                   bin_s=self.bin_s[n0:])
        if self.judged is None:
            # a traced run judges the window it traced
            gb.release_grower()
            self.judged = dict(index=i, ds=ds, booster=booster)
        return out

    def drop(self) -> None:
        j = self.judged
        b = j["booster"]
        b.num_trees()
        self.judged = dict(index=j["index"],
                           codes=j["ds"]._handle.binned.cpu(),
                           trees=plain_trees(b._gbdt.models),
                           score=b._gbdt.train_score[0].cpu())

    def check(self):
        log = self.ctx.log
        i = self.judged["index"]
        x, y = self.windows[i % len(self.windows)]
        log(f"judged window {i} (rows {i % len(self.windows)})")
        p = self.judge_params()
        mism, bins = compare.codes_mismatch(x, self.judged["codes"], p, log)
        out = compare.judge_trees(
            x, torch.from_numpy(y).to(x.device), p, bins, self.objective(),
            self.judged["trees"], [(0, None)], int(self.mix["ref_trees"]),
            self.judged["score"], log)
        return [("codes_mismatch", mism)] + list(out.items())
