"""Entry ``train_step``: the trainer's supervised step. Each call runs
``make_supervised_train_step(model)`` from ``vsrlab_tpu_torch.train.step``
on one batch of ``(lr, hr)`` clips from a pool of seeded batches already on
the card (it stands in for the loader), with the state that
``create_train_state`` and ``build_tx`` make: Adam as the traffic's
recipe states, the global gradient norm clipped, the Charbonnier loss of
the SR and the cleaned frames, the default metrics, no EMA, one
microbatch. The step's metrics are not read, so the host may dispatch
ahead as the trainer does; a stretch of steps ends with one synchronize.

Set-up drives that same state through its first ``checked_steps`` steps
on distinct batches (they are the warm-up too) and keeps what the
comparison reads: each step's loss, each step's gradients as Adam took
them (read back from its first moments) and each step's move of the
parameters. The reference then follows the same steps from the seed's
weights in float32 (TF32 off), in blocks of rows.

Compared, with parameters whose reference gradient is under a thousandth
of the median parameter's left out: ``grad_gap`` (by the worst parameter,
the gap between the norms of its first gradient on the two sides, over
the larger of the reference's norm of that parameter and of the median
parameter); ``median_step_gap`` (the same gap of each parameter's change
after the checked steps, its median over the parameters) and
``worst_step_gap`` (that gap's worst parameter): Adam moves each element
by about the learning rate whatever its gradient's size, so where a
parameter's steps partly cancel, the gradient elements that sit near
round-off set its change, and the worst parameter's gap swings from seed
to seed (``PERF.md``); for the worst parameter each step's gradient and
move norms and the share of its gradient elements whose signs agree go to
standard error. ``frozen_change`` is the largest change of a parameter the
configuration freezes (exactly 0). Each step's loss gap goes to standard
error and is not compared: the control's and the faults' readings of it
come no higher than three times the program's (see ``PERF.md``).

Faults: ``control`` (the reference computed with float8 operands in the
program's place), ``stale`` (a step that leaves the state as it was),
``half_batch`` (the step given the first half of each batch). A witness,
not a fault: ``fp32`` runs the program in float32 with TF32 off, the
reference's own precision.
"""

from __future__ import annotations

import contextlib
import dataclasses
import statistics
import sys
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from port_bench import program
from port_bench.common import make_clips
from port_bench.reference.layers import NoTF32, exact, fp8
from port_bench.reference.train import Adam, accumulated_grads

SMALL_GRAD = 1e-3  # of the median parameter's gradient norm


class Entry:
    kind = "train"
    faults = ("none", "control", "stale", "half_batch", "fp32")

    def __init__(self, cell, ranks, seed: int, fault: str = "none"):
        if fault not in self.faults:
            raise ValueError(f"cell {cell.name} has no fault {fault!r}: {self.faults}")
        if fault == "fp32":
            cell = dataclasses.replace(cell, config={**cell.config, "precision": "fp32"})
        self.cell, self.ranks, self.seed, self.fault = cell, ranks, seed, fault
        self.device = ranks.device
        self.traffic = cell.traffic
        self.recipe = self.traffic["recipe"]
        self.widths = cell.config["model"]
        self.ref = cell.reference_module()
        self.units = self.traffic["batch"]
        self.names: List[str] = []

    # -- set-up ---------------------------------------------------------
    def setup(self):
        import time

        t0 = time.perf_counter()
        t = self.traffic
        s = self.widths.get("upscale", 4)
        hr = make_clips((t["batch"], t["frames"], t["height"] * s, t["width"] * s, 3), t["pool"],
                        self.seed, "train", self.device)
        # each clip its own contrast and level, as real clips differ; a
        # batch's clips in the order of their contrast, so that a step that
        # sees only part of a batch reads another loss
        gain, level = make_clips((2, t["batch"], 1, 1, 1, 1), t["pool"], self.seed, "levels",
                                 self.device).unbind(1)
        gain = (0.1 + 0.9 * gain).sort(1).values
        hr = hr.mul_(gain).add_(level * (1.0 - gain))
        n, b, f, hh, ww, c = hr.shape
        lr = F.avg_pool2d(hr.reshape(-1, hh, ww, c).permute(0, 3, 1, 2), s)
        lr = lr.permute(0, 2, 3, 1).reshape(n, b, f, hh // s, ww // s, c)
        self.pool = [{"lr": lr[i].contiguous(), "hr": hr[i].contiguous()} for i in range(n)]
        del hr, lr
        t1 = time.perf_counter()
        if self.fault == "control":
            self._setup_control()
        else:
            self._setup_program()
        t2 = time.perf_counter()
        checked = int(t["checked_steps"])
        if checked > len(self.pool):
            raise ValueError("the checked steps need a distinct batch each")
        before = [p.detach().float().clone() for p in self.leaves]
        self.losses, self.grads, self.moves, self._moments = [], [], [], None
        for i in range(checked):
            self.losses.append(self.dispatch(i))
            self.grads.append(self.taken_grads())
            now = [p.detach().float().clone() for p in self.leaves]
            self.moves.append(torch._foreach_sub(now, before))
            before = now
        del before
        self.phases = {"batches_s": t1 - t0, "program_s": t2 - t1,
                       "checked_steps_s": time.perf_counter() - t2}

    def _setup_program(self):
        from vsrlab_tpu_torch.train.builders import build_tx
        from vsrlab_tpu_torch.train.state import create_train_state
        from vsrlab_tpu_torch.train.step import make_supervised_train_step

        r = self.recipe
        self.model = program.build(self.cell, self.seed, self.device).train()
        tx = build_tx(self.model.parameters(),
                      ("adam", {"lr": r["lr"], "betas": tuple(r["betas"]), "eps": r["eps"]}),
                      None, grad_clip=r["grad_clip"])
        self.state = create_train_state(self.model, tx)
        self.train_step = make_supervised_train_step(self.model)
        self.names = [n for n, _ in self.model.named_parameters()]
        self.leaves = [p for _, p in self.model.named_parameters()]
        if self.fault == "stale":
            tx.step = lambda: torch.zeros((), device=self.device)

    def _setup_control(self):
        self.model = torch.nn.Module()
        self.params, self.adam = self._reference_state()
        self.names = list(self.params)
        self.leaves = [self.params[k] for k in self.names]

    def _reference_state(self) -> Tuple[Dict[str, torch.Tensor], Adam]:
        r = self.recipe
        params = {k: v.clone().requires_grad_(not self.ref.frozen(k, **self.widths))
                  for k, v in program.weights(self.cell, self.seed, self.device).items()}
        adam = Adam(list(params.values()), r["lr"], r["betas"], r["eps"], r["grad_clip"])
        return params, adam

    def _reference_step(self, params, adam, batch, q):
        names = list(params)

        def fwd(p, x):
            return self.ref.forward(p, x, q, **self.widths)

        with NoTF32():
            loss, grads = accumulated_grads(fwd, params, names, batch["lr"], batch["hr"],
                                            int(self.traffic["reference_rows"]))
        used = adam.step(grads)
        return loss, used

    def taken_grads(self) -> List[torch.Tensor]:
        """Each parameter's gradient of the step just made, as the optimizer
        took it: ``(m_t - beta1 m_(t-1)) / (1 - beta1)`` from Adam's first
        moments."""
        if self.fault == "control":
            return self._control_grads
        opt = self.state.tx.optimizer
        beta1 = opt.param_groups[0]["betas"][0]
        moments = [opt.state[p]["exp_avg"].float().clone() if "exp_avg" in opt.state.get(p, {})
                   else torch.zeros_like(p, dtype=torch.float32) for p in self.leaves]
        prev = self._moments or [torch.zeros_like(m) for m in moments]
        self._moments = moments
        return torch._foreach_div(torch._foreach_sub(moments, torch._foreach_mul(prev, beta1)),
                                  1.0 - beta1)

    # -- the calls ------------------------------------------------------
    def dispatch(self, i: int):
        batch = self.pool[i % len(self.pool)]
        if self.fault == "half_batch":
            half = batch["lr"].shape[0] // 2
            batch = {k: v[:half] for k, v in batch.items()}
        if self.fault == "control":
            loss, used = self._reference_step(self.params, self.adam, batch, fp8)
            self._control_grads = [g.detach().clone() for g in used]
            return torch.tensor(loss)
        with NoTF32() if self.fault == "fp32" else contextlib.nullcontext():
            _, metrics = self.train_step(self.state, batch)
        return metrics["Loss"]

    def collect(self, i: int, out, keep: bool):
        pass

    def drop(self, i: int):
        pass

    def finish(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def release(self):
        self.model = self.state = self.train_step = self.params = self.adam = None
        self.leaves = []

    # -- the comparison -------------------------------------------------
    def check(self, kept) -> Dict[str, Tuple[float, float]]:
        limits = self.cell.check
        losses = [float(v) for v in self.losses]

        def norms(tensors):
            return torch.stack(torch._foreach_norm(tensors)).double().cpu()

        grads = norms(self.grads[0])
        changes = norms([sum(m) for m in zip(*self.moves)])
        params, adam = self._reference_state()
        order = [list(params).index(k) for k in self.names]
        before = [params[k].detach().clone() for k in self.names]
        ref_losses, ref_step_grads, ref_moves = [], [], []
        for i in range(len(losses)):
            loss, used = self._reference_step(params, adam, self.pool[i], exact)
            ref_losses.append(loss)
            ref_step_grads.append([used[j].detach().clone() for j in order])
            now = [params[k].detach().clone() for k in self.names]
            ref_moves.append(torch._foreach_sub(now, before))
            before = now
        ref_grads = norms(ref_step_grads[0])
        ref_changes = norms([sum(m) for m in zip(*ref_moves)])
        frozen = [self.ref.frozen(k, **self.widths) for k in self.names]
        live = [j for j, fz in enumerate(frozen) if not fz]
        median = statistics.median(float(ref_grads[j]) for j in live)
        counted = [j for j in live if float(ref_grads[j]) >= SMALL_GRAD * median]

        def leaf_gaps(what, mine, ref):
            """Each counted parameter's gap; the worst three go to standard error."""
            mid = statistics.median(float(ref[j]) for j in counted)
            out = {self.names[j]: abs(float(mine[j]) - float(ref[j])) / max(float(ref[j]), mid)
                   for j in counted}
            top = sorted(out.items(), key=lambda kv: -kv[1])[:3]
            print(f"{what} gaps, the worst parameters: "
                  + ", ".join(f"{k} {v:.6g} ({float(mine[self.names.index(k)]):.6g} against "
                              f"{float(ref[self.names.index(k)]):.6g})" for k, v in top)
                  + f"; median {statistics.median(out.values()):.6g}", file=sys.stderr)
            return out

        gaps = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
        print("loss gaps by step: " + ", ".join(f"{g:.6g}" for g in gaps)
              + f"; losses {losses} against {ref_losses}", file=sys.stderr)
        frozen_change = max([float(changes[j]) for j, fz in enumerate(frozen) if fz],
                            default=0.0)
        change_gaps = leaf_gaps("change", changes, ref_changes)
        worst = max(change_gaps, key=change_gaps.get)
        self._story(worst, self.names.index(worst), ref_step_grads, ref_moves, counted)
        return {
            "grad_gap": (max(leaf_gaps("first gradient", grads, ref_grads).values()),
                         limits["grad_gap"]),
            "median_step_gap": (statistics.median(change_gaps.values()),
                                limits["median_step_gap"]),
            "worst_step_gap": (change_gaps[worst], limits["worst_step_gap"]),
            "frozen_change": (frozen_change, limits["frozen_change"]),
        }

    def _story(self, name, j, ref_grads, ref_moves, counted):
        """To standard error, for parameter ``j``: each step's gradient and
        move norms on both sides and the share of its gradient elements whose
        signs agree (beside that share's median over the counted
        parameters), and how far its steps cancel: the norm of their sum
        over the sum of their norms."""
        def agree(a, b):
            return float((torch.sign(a.float()) == torch.sign(b.float())).float().mean())

        lines = []
        for t, (g, rg, m, rm) in enumerate(zip(self.grads, ref_grads, self.moves, ref_moves)):
            typical = statistics.median(agree(g[k], rg[k]) for k in counted)
            lines.append(f"step {t + 1}: gradient norm {float(g[j].norm()):.6g} against "
                         f"{float(rg[j].norm()):.6g}, signs agreeing {agree(g[j], rg[j]):.4f} "
                         f"(median parameter {typical:.4f}), move norm {float(m[j].norm()):.6g} "
                         f"against {float(rm[j].norm()):.6g}")

        def cancel(moves):
            total = sum(float(m[j].norm()) for m in moves)
            return float(sum(m[j] for m in moves).norm()) / total if total else float("nan")

        print(f"worst change, {name}: " + "; ".join(lines) + f"; steps' sum over their norms "
              f"{cancel(self.moves):.4f} against {cancel(ref_moves):.4f}", file=sys.stderr)

    def work(self):
        from port_bench.reference.train import supervised_loss
        from port_bench.work import train_flops

        b = self.pool[0]
        return train_flops(self.ref, self.widths, tuple(b["lr"].shape), tuple(b["hr"].shape),
                           supervised_loss)
