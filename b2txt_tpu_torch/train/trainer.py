"""Training loop for the brain-to-text GRU decoder.

Counterpart of ``b2txt_tpu/train/trainer.py`` (the reference's
rnn_trainer.py:27-770): day-sampled batches, augmentations (or the fused
kernel K3 with ``use_fused_preprocess``), the bf16 compute policy
(``use_amp``), CTC loss, 3-group AdamW with cosine warmup, clipping by global
norm, periodic validation with greedy-CTC PER (per-day breakdown), best-PER
checkpointing with a loss tiebreak, early stopping, metrics pickles and
train_val_trials.json provenance.

The step runs eagerly on the model's device: the GRU recurrence goes
through K1 forward and K2 backward on the card. Data comes from the HDF5
sessions named by the config, as in the JAX package, or from trials in
memory (``train_trials`` / ``val_trials``), which need neither h5py nor
files. Randomness (augmentation, dropout) comes from one ``torch.Generator``
on the device, seeded with ``cfg.seed``. No mesh: data parallelism waits
for the port of ``parallel/``.
"""

from __future__ import annotations

import json
import os
import pickle
import time
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..data.hdf5_store import Trial, train_test_split_indices
from ..data.loader import BatchLoader, prefetch_iterator
from ..data.sampler import BatchSampler
from ..models.gru_decoder import GRUDecoder
from ..ops.augment import TransformArgs, transform_data
from ..ops.ctc import batched_greedy_collapse, ctc_loss, greedy_decode_ids
from ..ops.preprocess import fused_preprocess
from ..utils.config import TrainConfig
from ..utils.device import resolve_device
from ..utils.logging import make_logger
from ..utils.metrics import batch_greedy_per
from .checkpoint import load_checkpoint, save_checkpoint, to_tensor_tree
from .optimizer import (clip_by_global_norm_, global_norm, make_optimizer,
                        set_learning_rates, trainability_mask)

Batch = Dict[str, Any]


def _flush_losses(pending: list, out: list) -> None:
    """Device loss scalars → floats in one stacked copy (a per-step float()
    would make every step wait for the card)."""
    if pending:
        out.extend(torch.stack(pending).float().cpu().tolist())
        pending.clear()


def _in_memory_indices(trials: Dict[int, List[Trial]]) -> Dict[int, Dict[str, Any]]:
    return {d: {"trials": list(range(len(ts))), "session_path": None}
            for d, ts in trials.items()}


class Trainer:
    def __init__(
        self,
        cfg: TrainConfig,
        logger=None,
        device: Optional[Union[str, torch.device]] = None,
        train_trials: Optional[Dict[int, List[Trial]]] = None,
        val_trials: Optional[Dict[int, List[Trial]]] = None,
    ):
        """``device=None`` trains on the CUDA card (and raises without one).
        ``train_trials`` / ``val_trials``: {day: [Trial, ...]} in memory,
        in place of ``cfg.dataset``'s HDF5 sessions."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.logger = logger or make_logger(
            "b2txt_tpu_torch.train",
            os.path.join(cfg.output_dir, "training_log") if cfg.mode == "train" else None,
        )
        if cfg.mode == "train":
            os.makedirs(cfg.output_dir, exist_ok=True)
        if cfg.save_best_checkpoint or cfg.save_all_val_steps or cfg.save_final_model:
            os.makedirs(cfg.checkpoint_dir, exist_ok=True)

        self.best_val_per = float("inf")
        self.best_val_loss = float("inf")
        seed = cfg.seed if cfg.seed != -1 else 0
        self.seed = seed
        self.n_days = len(cfg.dataset.sessions)
        self.model = GRUDecoder(cfg.model, self.n_days, cfg.dataset.n_classes, device=self.device,
                                generator=torch.Generator().manual_seed(seed))
        n_params = sum(p.numel() for p in self.model.parameters())
        self.logger.info(f"Initialized GRU decoder: {n_params:,} parameters on {self.device}")

        if train_trials is None:
            train_paths = [os.path.join(cfg.dataset.dataset_dir, s, "data_train.hdf5")
                           for s in cfg.dataset.sessions]
            val_paths = [os.path.join(cfg.dataset.dataset_dir, s, "data_val.hdf5")
                         for s in cfg.dataset.sessions]
            if len(set(train_paths)) != len(train_paths):
                raise ValueError("There are duplicate sessions listed in the train dataset")
            train_idx, _ = train_test_split_indices(train_paths, test_percentage=0,
                                                    seed=cfg.dataset.seed)
            _, val_idx = train_test_split_indices(val_paths, test_percentage=1,
                                                  seed=cfg.dataset.seed)
        else:
            train_idx = _in_memory_indices(train_trials)
            val_idx = _in_memory_indices(val_trials or {d: [] for d in train_trials})

        if cfg.mode == "train":
            with open(os.path.join(cfg.output_dir, "train_val_trials.json"), "w") as f:
                json.dump({"train": train_idx, "val": val_idx}, f)

        self.train_sampler = BatchSampler(
            train_idx, n_batches=cfg.num_training_batches, split="train",
            batch_size=cfg.dataset.batch_size, days_per_batch=cfg.dataset.days_per_batch,
            random_seed=cfg.dataset.seed, must_include_days=cfg.dataset.must_include_days,
            feature_subset=cfg.dataset.feature_subset,
        )
        self.val_sampler = BatchSampler(
            val_idx, n_batches=None, split="test", batch_size=cfg.dataset.batch_size,
            random_seed=cfg.dataset.seed, feature_subset=cfg.dataset.feature_subset,
        )
        self.train_loader = BatchLoader(self.train_sampler,
                                        transfer_dtype=cfg.feature_transfer_dtype,
                                        trials=train_trials)
        self.val_loader = BatchLoader(self.val_sampler,
                                      transfer_dtype=cfg.feature_transfer_dtype,
                                      trials=val_trials)

        self.optimizer, self.schedules = make_optimizer(cfg, self.model)
        self.train_mask = trainability_mask(cfg, self.model)
        self.step = 0
        self.transform_args = TransformArgs.from_config(cfg.dataset.data_transforms)
        self.compute_dtype = torch.bfloat16 if cfg.use_amp else torch.float32
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

        if cfg.init_from_checkpoint:
            self.load(cfg.init_checkpoint_path)

    # ------------------------------------------------------------------ steps
    def _logits(self, batch: Batch, training: bool) -> Tuple[torch.Tensor, torch.Tensor]:
        """Augment/smooth → model. Returns (logits (B, P, C), adjusted lengths)."""
        cfg = self.cfg
        feats = batch["input_features"].float()
        n_time = batch["n_time_steps"]
        if training and cfg.use_fused_preprocess:
            feats, n_time = fused_preprocess(
                feats, n_time, self.transform_args, training=True, generator=self.generator,
                seed=self.seed * 1_000_003 + self.step,
            )
        else:
            feats, n_time = transform_data(feats, n_time, self.transform_args, training,
                                           generator=self.generator)
        adjusted = (n_time - cfg.model.patch_size) // cfg.model.patch_stride + 1
        logits = self.model(feats, batch["day_indicies"], compute_dtype=self.compute_dtype,
                            training=training, generator=self.generator)
        return logits, adjusted

    def _loss(self, logits: torch.Tensor, adjusted: torch.Tensor, batch: Batch):
        log_probs = torch.log_softmax(logits.float(), dim=-1)
        losses = ctc_loss(log_probs, batch["seq_class_ids"], adjusted, batch["phone_seq_lens"])
        return log_probs, losses.mean()

    def train_step(self, batch: Batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """One update on a batch of device tensors. Returns (loss, grad_norm)
        as device scalars; grad_norm is taken after masking, before clipping."""
        logits, adjusted = self._logits(batch, training=True)
        _, loss = self._loss(logits, adjusted, batch)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        grads = []
        for name, p in self.model.named_parameters():
            if p.grad is None or not self.train_mask[name]:
                p.grad = torch.zeros_like(p)  # frozen: zeros, so AdamW still steps them
            grads.append(p.grad)
        grad_norm = global_norm(grads)
        if self.cfg.grad_norm_clip_value > 0:
            clip_by_global_norm_(grads, self.cfg.grad_norm_clip_value, grad_norm)
        set_learning_rates(self.optimizer, self.schedules, self.step)
        self.optimizer.step()
        self.step += 1
        return loss.detach(), grad_norm

    @torch.no_grad()
    def eval_step(self, batch: Batch):
        """(logits f32, mean loss, greedy ids, adjusted lengths) on device."""
        logits, adjusted = self._logits(batch, training=False)
        log_probs, loss = self._loss(logits, adjusted, batch)
        return logits.float(), loss, greedy_decode_ids(log_probs, adjusted), adjusted

    # ------------------------------------------------------------------ train
    def train(self) -> Dict[str, Any]:
        cfg = self.cfg
        train_losses, val_losses, val_pers, val_results = [], [], [], []
        pending_losses: list = []
        val_steps_since_improvement = 0
        train_start = time.time()

        i = 0
        for i, batch in enumerate(prefetch_iterator(self.train_loader, self.device)):
            t0 = time.time()
            loss, grad_norm = self.train_step(batch)
            pending_losses.append(loss)

            if i % cfg.batches_per_train_log == 0:
                _flush_losses(pending_losses, train_losses)
                self.logger.info(
                    f"Train batch {i}: loss: {train_losses[-1]:.2f} "
                    f"grad norm: {float(grad_norm):.2f} time: {time.time() - t0:.3f}"
                )

            if i % cfg.batches_per_val_step == 0 or i == cfg.num_training_batches - 1:
                _flush_losses(pending_losses, train_losses)
                t0 = time.time()
                val_metrics = self.validation(return_logits=cfg.save_val_logits)
                self.logger.info(
                    f"Val batch {i}: PER (avg): {val_metrics['avg_PER']:.4f} "
                    f"CTC Loss (avg): {val_metrics['avg_loss']:.4f} "
                    f"time: {time.time() - t0:.3f}"
                )
                if cfg.log_individual_day_val_PER:
                    for day, dp in val_metrics["day_PERs"].items():
                        if dp["total_seq_length"] > 0:
                            self.logger.info(
                                f"{cfg.dataset.sessions[day]} val PER: "
                                f"{dp['total_edit_distance'] / dp['total_seq_length']:.4f}"
                            )
                val_pers.append(val_metrics["avg_PER"])
                val_losses.append(val_metrics["avg_loss"])
                val_results.append({k: v for k, v in val_metrics.items() if k != "logits"})

                new_best = False
                if val_metrics["avg_PER"] < self.best_val_per:
                    self.logger.info(
                        f"New best test PER {self.best_val_per:.4f} --> {val_metrics['avg_PER']:.4f}"
                    )
                    self.best_val_per = val_metrics["avg_PER"]
                    self.best_val_loss = val_metrics["avg_loss"]
                    new_best = True
                elif (val_metrics["avg_PER"] == self.best_val_per
                      and val_metrics["avg_loss"] < self.best_val_loss):
                    self.best_val_loss = val_metrics["avg_loss"]
                    new_best = True

                if new_best:
                    if cfg.save_best_checkpoint:
                        self.save(os.path.join(cfg.checkpoint_dir, "best_checkpoint"),
                                  self.best_val_per, self.best_val_loss)
                    if cfg.save_val_metrics:
                        with open(os.path.join(cfg.checkpoint_dir, "val_metrics.pkl"), "wb") as f:
                            pickle.dump(val_metrics, f)
                    val_steps_since_improvement = 0
                else:
                    val_steps_since_improvement += 1

                if cfg.save_all_val_steps:
                    self.save(os.path.join(cfg.checkpoint_dir, f"checkpoint_batch_{i}"),
                              val_metrics["avg_PER"], val_metrics["avg_loss"])

                if cfg.early_stopping and (
                    val_steps_since_improvement >= cfg.early_stopping_val_steps
                ):
                    self.logger.info(
                        f"Early stopping at batch {i}: no improvement in "
                        f"{cfg.early_stopping_val_steps} validation steps"
                    )
                    break

        _flush_losses(pending_losses, train_losses)
        self.logger.info(f"Best avg val PER achieved: {self.best_val_per:.5f}")
        self.logger.info(f"Total training time: {(time.time() - train_start) / 60:.2f} minutes")
        if cfg.save_final_model:
            self.save(
                os.path.join(cfg.checkpoint_dir, f"final_checkpoint_batch_{i}"),
                val_pers[-1] if val_pers else float("inf"),
                val_losses[-1] if val_losses else float("inf"),
            )
        return {"train_losses": train_losses, "val_losses": val_losses,
                "val_PERs": val_pers, "val_metrics": val_results}

    # ------------------------------------------------------------- validation
    def validation(self, return_logits: bool = False) -> Dict[str, Any]:
        cfg = self.cfg
        metrics: Dict[str, Any] = {
            "decoded_seqs": [], "true_seq": [], "phone_seq_lens": [],
            "losses": [], "block_nums": [], "trial_nums": [], "day_indicies": [],
        }
        if return_logits:
            metrics["logits"] = []
            metrics["n_time_steps"] = []

        total_ed, total_len = 0, 0
        day_per = {
            d: {"total_edit_distance": 0, "total_seq_length": 0}
            for d in range(self.n_days)
            if not cfg.dataset.dataset_probability_val
            or cfg.dataset.dataset_probability_val[d] == 1
        }

        for batch in prefetch_iterator(self.val_loader, self.device):
            day = int(batch["day_indicies"][0])
            if cfg.dataset.dataset_probability_val and cfg.dataset.dataset_probability_val[day] == 0:
                if cfg.log_val_skip_logs:
                    self.logger.info(f"Skipping validation on day {day}")
                continue

            logits, loss, ids, adjusted = self.eval_step(batch)
            labels = batch["seq_class_ids"].cpu().numpy()
            lab_lens = batch["phone_seq_lens"].cpu().numpy()
            decoded = batched_greedy_collapse(ids.cpu().numpy(), adjusted.cpu().numpy())
            trues = [labels[b, : lab_lens[b]] for b in range(len(decoded))]
            ed, ln = batch_greedy_per(decoded, trues)
            total_ed += ed
            total_len += ln
            if day in day_per:
                day_per[day]["total_edit_distance"] += ed
                day_per[day]["total_seq_length"] += ln

            metrics["losses"].append(float(loss))
            metrics["decoded_seqs"].append(decoded)
            metrics["true_seq"].append(labels)
            metrics["phone_seq_lens"].append(lab_lens)
            metrics["block_nums"].append(batch["block_nums"])
            metrics["trial_nums"].append(batch["trial_nums"])
            metrics["day_indicies"].append(batch["day_indicies"].cpu().numpy())
            if return_logits:
                metrics["logits"].append(logits.cpu().numpy())
                metrics["n_time_steps"].append(adjusted.cpu().numpy())

        metrics["day_PERs"] = day_per
        metrics["avg_PER"] = total_ed / max(total_len, 1)
        metrics["avg_loss"] = (float(np.mean(metrics["losses"])) if metrics["losses"]
                               else float("inf"))
        return metrics

    # ------------------------------------------------------------ checkpoints
    def save(self, path: str, val_per: float, val_loss: float) -> None:
        """Parameters (reference names), optimizer state, step and metrics;
        the config goes beside it as args.yaml (which needs PyYAML)."""
        save_checkpoint(path, self.model.state_dict(), self.optimizer.state_dict(),
                        self.step, val_per, val_loss)
        self.cfg.save(os.path.join(self.cfg.checkpoint_dir, "args.yaml"))
        self.logger.info(f"Saved model to checkpoint: {path}")

    def load(self, path: str) -> None:
        ckpt = load_checkpoint(path)
        self.model.load_state_dict(to_tensor_tree(ckpt["params"]))
        if ckpt.get("opt_state") is not None:
            self.optimizer.load_state_dict(to_tensor_tree(ckpt["opt_state"]))
        self.step = ckpt.get("step", 0)
        self.best_val_per = ckpt.get("val_PER", float("inf"))
        self.best_val_loss = ckpt.get("val_loss", float("inf"))
        self.logger.info(f"Loaded model from checkpoint: {path}")
