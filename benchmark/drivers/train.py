"""The retraining job: the program's ``Trainer.train_step`` over batches
from its own loader.

Set-up builds one ``Trainer`` (the configuration's ``TrainConfig``: batch
64 over 4 days, the unfused augmentation, bf16, AdamW), loads the
benchmark's initial weights into its model, hands it planted sessions held
in memory (``train_trials``), and drives its first ``check_steps`` steps
through the window's own feed and call, recording each step's batch, the
augmentation's draws and the dropout masks. The window then runs the same
object on: every step is ``train_step`` on the next batch of
``prefetch_iterator(trainer.train_loader)``, the losses flushed to the host
every ``batches_per_train_log`` steps as ``Trainer.train`` does, and the
window ends in a sync. ``step_ms`` is the window over the steps it
completed.

The comparison follows those first steps in float32 from the same initial
weights and the program's draws: each step's loss, the first gradient as
the optimizer got it (read back from AdamW's first moment), and the
parameters' change after the steps, each by the worst leaf.
"""

from __future__ import annotations

import math
import os
import shutil
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from ..harness import Spans
from ..reference.train import train_steps
from ..traffic import make_trials, stratified
from ..world import build_world, phoneme_code


def initial_weights(model_cfg: Dict, n_days: int, seed: int, device) -> Dict[str, torch.Tensor]:
    """The reference's initial distributions, drawn on ``device`` from
    ``seed``: identity day layers with zero biases, Xavier-uniform input and
    head weights, orthogonal recurrent weights, U(+-1/sqrt(H)) biases,
    a Xavier-uniform h0."""
    D, H, L = model_cfg["n_input_features"], model_cfg["n_units"], model_cfg["n_layers"]
    C, ps = model_cfg["n_classes"], model_cfg["patch_size"]
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    sd: Dict[str, torch.Tensor] = {}
    for i in range(n_days):
        sd[f"day_weights.{i}"] = torch.eye(D, device=device)
        sd[f"day_biases.{i}"] = torch.zeros((1, D), device=device)
    kb = 1.0 / math.sqrt(H)

    def xavier(shape):
        lim = math.sqrt(6.0 / (shape[0] + shape[1]))
        return torch.empty(shape, device=device).uniform_(-lim, lim, generator=gen)

    for k in range(L):
        in_dim = D * ps if k == 0 else H
        sd[f"gru.weight_ih_l{k}"] = xavier((3 * H, in_dim))
        a = torch.randn((3 * H, H), generator=gen, device=device)
        qm, r = torch.linalg.qr(a)
        sd[f"gru.weight_hh_l{k}"] = (qm * torch.sign(torch.diagonal(r))).contiguous()
        sd[f"gru.bias_ih_l{k}"] = torch.empty(3 * H, device=device).uniform_(-kb, kb, generator=gen)
        sd[f"gru.bias_hh_l{k}"] = torch.empty(3 * H, device=device).uniform_(-kb, kb, generator=gen)
    sd["out.weight"] = xavier((C, H))
    sd["out.bias"] = torch.empty(C, device=device).uniform_(-kb, kb, generator=gen)
    sd["h0"] = xavier((1, H)).reshape(1, 1, H)
    return sd


class Cell:
    def __init__(self, config: Dict, traffic: Dict, seed: int, device):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.spans = Spans()
        self.attempted = 0
        self.failed = 0

    def _train_config(self):
        from b2txt_tpu_torch.utils.config import TrainConfig

        cfg, tr = self.config, self.config["train"]
        tc = TrainConfig()
        m = cfg["model"]
        for key in ("n_input_features", "n_units", "n_layers", "patch_size", "patch_stride",
                    "rnn_dropout"):
            setattr(tc.model, key, tr.get(key, m.get(key)))
        tc.model.input_network.input_layer_dropout = tr["input_layer_dropout"]
        for key in ("lr_max", "lr_min", "lr_decay_steps", "lr_warmup_steps", "lr_max_day",
                    "lr_min_day", "lr_decay_steps_day", "lr_warmup_steps_day", "weight_decay",
                    "weight_decay_day", "beta0", "beta1", "epsilon", "grad_norm_clip_value",
                    "num_training_batches", "batches_per_train_log", "use_amp",
                    "use_fused_preprocess", "seed"):
            setattr(tc, key, tr[key])
        tc.dataset.batch_size = tr["batch_size"]
        tc.dataset.days_per_batch = tr["days_per_batch"]
        tc.dataset.seed = tr["dataset_seed"]
        tc.dataset.n_classes = m["n_classes"]
        dt = tc.dataset.data_transforms
        for key, v in tr["augment"].items():
            setattr(dt, key, v)
        dt.smooth_kernel_std = m["smooth_kernel_std"]
        dt.smooth_kernel_size = m["smooth_kernel_size"]
        tc.dataset.sessions = [f"day{i:02d}" for i in range(m["n_days"])]
        # the job writes its log and provenance under the run's TMPDIR
        self.out_dir = tempfile.mkdtemp(prefix="bench_train_")
        tc.output_dir = os.path.join(self.out_dir, "out")
        tc.checkpoint_dir = os.path.join(self.out_dir, "ckpt")
        tc.save_best_checkpoint = tc.save_all_val_steps = tc.save_final_model = False
        return tc

    def setup(self) -> None:
        from b2txt_tpu_torch.data.hdf5_store import Trial
        from b2txt_tpu_torch.data.loader import prefetch_iterator
        from b2txt_tpu_torch.models import gru_decoder
        from b2txt_tpu_torch.ops import augment
        from b2txt_tpu_torch.train import Trainer

        cfg, m = self.config, self.config["model"]
        tc = self._train_config()
        _, words, prons = build_world(cfg["world"])
        code = torch.from_numpy(phoneme_code(m["n_input_features"], m["n_classes"])).to(self.device)
        rng = np.random.default_rng(self.seed)
        gen = torch.Generator(device=self.device).manual_seed(self.seed % (2 ** 63))
        n_days, per_day = int(m["n_days"]), int(self.traffic["trials_per_day"])
        lengths = stratified(*self.traffic["bins"], n_days * per_day, rng)
        self.trials: Dict[int, List] = {}
        for d in range(n_days):
            ts = make_trials(lengths[d * per_day: (d + 1) * per_day], words, prons, code,
                             rng, gen, float(self.traffic["feature_noise"]))
            self.trials[d] = ts
        train_trials = {d: [Trial(input_features=t.features,
                                  seq_class_ids=np.asarray(t.phone_ids, np.int32),
                                  transcription=None, n_time_steps=t.features.shape[0],
                                  seq_len=len(t.phone_ids), block_num=0, trial_num=i,
                                  session=tc.dataset.sessions[d], sentence_label=t.sentence)
                            for i, t in enumerate(ts)] for d, ts in self.trials.items()}
        self.trainer = Trainer(tc, device=self.device, train_trials=train_trials)
        self.init = initial_weights(m, n_days, self.seed, self.device)
        self.trainer.model.load_state_dict(self.init)
        self.batches = prefetch_iterator(self.trainer.train_loader, self.device)

        # the first steps, through the window's feed and call, recorded
        draws_box: List = []
        masks_box: List = []
        orig_draw, orig_drop = augment.draw_transform, gru_decoder.dropout

        def draw_spy(features, args, generator=None):
            d = orig_draw(features, args, generator)
            draws_box.append(d)
            return d

        def drop_spy(x, p, generator):
            out = orig_drop(x, p, generator)
            masks_box.append((out != 0) | (x == 0))
            return out

        self.steps: List[Dict] = []
        self.prog_losses, self.prog_grad1 = [], None
        augment.draw_transform, gru_decoder.dropout = draw_spy, drop_spy
        try:
            for i in range(int(self.traffic["check_steps"])):
                batch = next(self.batches)
                loss, _ = self.trainer.train_step(batch)
                self.prog_losses.append(loss)
                self.steps.append({"batch": self._ref_batch(batch), "draws": {
                    "white": draws_box[-1].white, "offset": draws_box[-1].offset,
                    "cut": int(draws_box[-1].cut)}, "masks": list(masks_box)})
                masks_box.clear()
                if i == 0:
                    self.prog_grad1 = self._first_moments()
        finally:
            augment.draw_transform, gru_decoder.dropout = orig_draw, orig_drop
        self.prog_after = {k: v.detach().clone()
                           for k, v in self.trainer.model.state_dict().items()}
        self.prog_losses = [float(v) for v in torch.stack(self.prog_losses).cpu()]

    def _ref_batch(self, batch) -> Dict:
        """The step's rows rebuilt from the benchmark's own trials, found by
        their day and trial number, padded as the loader pads."""
        days = batch["day_indicies"].cpu().numpy()
        nums = batch["trial_nums"]
        T = batch["input_features"].shape[1]
        S = batch["seq_class_ids"].shape[1]
        feats = np.zeros((len(days), T, self.trials[0][0].features.shape[1]), np.float32)
        labels = np.zeros((len(days), S), np.int64)
        n_time, lens = [], []
        for r, (d, i) in enumerate(zip(days, nums)):
            t = self.trials[int(d)][int(i)]
            feats[r, : t.features.shape[0]] = t.features
            labels[r, : len(t.phone_ids)] = t.phone_ids
            n_time.append(t.features.shape[0])
            lens.append(len(t.phone_ids))
        dev = self.device
        return {"features": torch.from_numpy(feats).to(dev),
                "labels": torch.from_numpy(labels).to(dev),
                "n_time_steps": torch.as_tensor(n_time, device=dev),
                "label_lens": torch.as_tensor(lens, device=dev),
                "days": torch.as_tensor(days, device=dev),
                "same_rows": bool(torch.equal(batch["input_features"].float().cpu(),
                                              torch.from_numpy(feats)))}

    def _first_moments(self) -> Dict[str, float]:
        """Each leaf's first gradient as AdamW got it: exp_avg / (1 - beta0)."""
        beta0 = float(self.config["train"]["beta0"])
        out = {}
        for name, p in self.trainer.model.named_parameters():
            st = self.trainer.optimizer.state.get(p, {})
            if "exp_avg" in st:
                out[name] = float(st["exp_avg"].double().norm() / (1.0 - beta0))
        return out

    def window(self, seconds: float) -> None:
        log_every = int(self.config["train"]["batches_per_train_log"])
        pending, losses = [], []
        n = 0
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        t_start = time.perf_counter()
        while True:
            loss, grad_norm = self.trainer.train_step(next(self.batches))
            pending.append(loss)
            n += 1
            if n % log_every == 0:
                losses += torch.stack(pending).float().cpu().tolist()
                pending.clear()
                float(grad_norm)
            if time.perf_counter() - t_start >= seconds:
                break
        if pending:
            losses += torch.stack(pending).float().cpu().tolist()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - t_start
        self.attempted = n
        self.failed = sum(1 for v in losses if not math.isfinite(v))
        self.spans.count("steps", n)

    def work(self, first: int, n: int):
        """(bins, frames, rows, [(rows, frames) a batch]) of the loader's
        batches first .. first + n - 1, from the sampler's index and the
        trials' own lengths (no padding)."""
        m = self.config["model"]
        ps, st = int(m["patch_size"]), int(m["patch_stride"])
        bins = frames = rows = 0
        per = []
        for b in range(first, first + n):
            index = self.trainer.train_sampler.batch_index[b]
            ts = [self.trials[int(d)][int(i)].features.shape[0]
                  for d, idx in index.items() for i in idx]
            fr = [(t - ps) // st + 1 for t in ts]
            bins, frames, rows = bins + sum(ts), frames + sum(fr), rows + len(ts)
            per.append((len(ts), fr))
        return bins, frames, rows, per

    def detail(self) -> Dict:
        return {"window_s": self.window_s, "steps": self.attempted,
                "check_losses": self.prog_losses}

    def end_to_end(self) -> Dict[str, float]:
        return {"step_ms": 1e3 * self.window_s / self.attempted}

    def traced(self) -> None:
        """``trace_steps`` steps under the profiler."""
        n = int(self.traffic["trace_steps"])
        for _ in range(n):
            with torch.profiler.record_function("bench.step"):
                self.trainer.train_step(next(self.batches))
        self.traced_steps = n
        self.traced_first = int(self.traffic["check_steps"]) + self.attempted

    def free(self) -> None:
        self.batches.close()
        del self.trainer, self.batches
        shutil.rmtree(self.out_dir, ignore_errors=True)

    # ------------------------------------------------------------ check
    def check(self, control: str = "") -> Dict[str, float]:
        ref = train_steps(self.init, self.steps, self.config)
        if control:
            got = train_steps(self.init, self.steps, self.config, control=control)
            losses, grad1 = got["losses"], got["grad_norms"][0]
            after = got["params"]
        else:
            losses, grad1, after = self.prog_losses, self.prog_grad1, self.prog_after
        rows_ok = all(s["batch"]["same_rows"] for s in self.steps)
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"]))
        # the median leaf is taken over the leaves the step reaches: the day
        # layers of days outside a batch get no gradient at all
        def median(values):
            return float(np.median([v for v in values if v > 0]))

        g_ref = ref["grad_norms"][0]
        g_med = median(g_ref.values())
        grad_gap = max(abs(grad1.get(n, 0.0) - g) / max(g, g_med) for n, g in g_ref.items())
        # leaves whose gradient is nought to rounding in the reference at
        # every step (under a thousandth of the median leaf's) move by
        # round-off alone: left out of the change by this rule
        meds = [median(g.values()) for g in ref["grad_norms"]]
        moved = [n for n in g_ref if any(g[n] >= 1e-3 * m for g, m in zip(ref["grad_norms"], meds))]
        d_ref = {n: float((ref["params"][n] - self.init[n]).double().norm()) for n in moved}
        d_got = {n: float((after[n].float() - self.init[n]).double().norm()) for n in moved}
        d_med = median(d_ref.values())
        change_gap = max(abs(d_got[n] - d_ref[n]) / max(d_ref[n], d_med) for n in moved)
        if not rows_ok:
            loss_gap = math.inf
        return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap,
                "draws_gap": self._draws_gap()}

    def _draws_gap(self) -> float:
        """The program's random values, which the reference follows, held
        apart to what the configuration states: the white noise and the
        offset standard normal, the cut in [0, random_cut), each dropout
        keeping its 1 - p share. The widest deviation of a mean, a standard
        deviation or a keep share, in its own standard errors over the
        values drawn (the cut out of range reads inf)."""
        tr = self.config["train"]
        z = []
        for s in self.steps:
            d = s["draws"]
            if not 0 <= d["cut"] < int(tr["augment"]["random_cut"]):
                return math.inf
            for x in (d["white"], d["offset"]):
                x, n = x.double(), x.numel()
                z += [abs(float(x.mean())) * math.sqrt(n),
                      abs(float(x.std()) - 1.0) * math.sqrt(2 * n)]
            keeps = [1.0 - tr["input_layer_dropout"]] + \
                [1.0 - tr["rnn_dropout"]] * (len(s["masks"]) - 1)
            for m, k in zip(s["masks"], keeps):
                z.append(abs(float(m.double().mean()) - k) / math.sqrt(k * (1 - k) / m.numel()))
        return max(z)
