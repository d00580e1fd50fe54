"""The step loop around the train step (port of
spatialvla_tpu/train/trainer.py): host batches -> train_step -> metrics
(JSONL, stdout and TensorBoard scalar events) -> step-numbered checkpoints
with their sidecar (``checkpoints.CheckpointManager``) -> resume from the
latest, with a ``torch.profiler`` trace over an optional step window. In a
run of several processes every process runs the loop and computes the same
metrics; process 0 alone writes and prints them."""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Callable, Dict, Iterator, Optional

import torch

from ..parallel.mesh import process_count, process_index
from .tb_writer import SummaryWriter


@dataclasses.dataclass
class TrainerConfig:
    output_dir: str = "output"
    max_steps: int = 1000
    log_every: int = 50
    save_every: int = 500
    save_total_limit: int = 3
    profile_steps: Optional[tuple] = None  # (start, stop) step window
    resume: bool = True
    tensorboard: bool = True  # also write events.out.tfevents scalars


class MetricsLogger:
    """metrics.jsonl + a stdout line per logged step + (optionally)
    TensorBoard scalar events under <output_dir>/tb."""

    def __init__(self, output_dir: str, *, tensorboard: bool = False):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, "metrics.jsonl")
        self._f = open(self.path, "a")
        self._tb = SummaryWriter(os.path.join(output_dir, "tb")) if tensorboard else None

    def log(self, step: int, metrics: Dict[str, Any]):
        row = {"step": int(step)}
        for k, v in metrics.items():
            try:
                row[k] = float(v)
            except (TypeError, ValueError):
                continue
        self._f.write(json.dumps(row) + "\n")
        self._f.flush()
        if self._tb is not None:
            self._tb.add_scalars(row["step"], {k: v for k, v in row.items() if k != "step"})
            self._tb.flush()
        parts = " ".join(f"{k}={v:.4f}" for k, v in row.items() if k != "step")
        print(f"[step {row['step']}] {parts}", flush=True)

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()


def train_loop(*, state, train_step: Callable, batches: Iterator[Dict[str, Any]],
               config: TrainerConfig, checkpoint_manager=None, sidecar: Optional[Dict] = None,
               step_args: tuple = (), on_metrics: Optional[Callable] = None):
    """Runs the loop; returns the final state.

    step signature: train_step(state, *step_args, batch) -> (state,
    metrics). Metrics are read back to the host (a device sync) only on
    logged steps: every ``log_every`` steps and the first;
    ``on_metrics(step, metrics)`` then sees them too. With a
    ``checkpoint_manager`` the loop first resumes from its latest step when
    that is past the state's own (``config.resume``; the state is restored
    in place), saves every ``save_every`` steps, and ends with a forced save
    (skipped when that step is already saved)."""
    primary = process_index() == 0
    logger = MetricsLogger(config.output_dir, tensorboard=config.tensorboard) if primary else None
    start_step = int(state["step"])
    if checkpoint_manager is not None and config.resume:
        latest = checkpoint_manager.latest_step()
        if latest is not None and latest > start_step:
            state = checkpoint_manager.restore(state)
            start_step = int(state["step"])
            if primary:
                print(f"resumed from checkpoint step {start_step}", flush=True)
    t_last, step_last = time.perf_counter(), start_step
    profiler = None
    for step in range(start_step, config.max_steps):
        window = config.profile_steps
        if window and profiler is None and window[0] <= step < window[1]:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            profiler = torch.profiler.profile(activities=activities)
            profiler.__enter__()
        batch = next(batches, None)
        if batch is None:
            break
        state, metrics = train_step(state, *step_args, batch)
        if profiler is not None and step + 1 >= window[1]:
            profiler = _stop_profiler(profiler, config.output_dir)
        if (step + 1) % config.log_every == 0 or step == start_step:
            metrics = {k: float(v) for k, v in metrics.items()}  # sync
            now = time.perf_counter()
            n_steps = step + 1 - step_last
            metrics["steps_per_sec"] = n_steps / (now - t_last) if step > start_step else 0.0
            t_last, step_last = now, step + 1
            if logger is not None:
                logger.log(step + 1, metrics)
            if on_metrics is not None:
                on_metrics(step + 1, metrics)
        if checkpoint_manager is not None and (step + 1) % config.save_every == 0:
            checkpoint_manager.save(step + 1, state, sidecar=sidecar)
    if profiler is not None:  # the loop ended inside the window
        _stop_profiler(profiler, config.output_dir)
    if checkpoint_manager is not None:
        checkpoint_manager.save(int(state["step"]), state, sidecar=sidecar, force=True)
        checkpoint_manager.wait()
    if logger is not None:
        logger.close()
    return state


def _stop_profiler(profiler, output_dir: str):
    profiler.__exit__(None, None, None)
    os.makedirs(os.path.join(output_dir, "traces"), exist_ok=True)
    name = "trace.json" if process_count() == 1 else f"trace-{process_index()}.json"
    profiler.export_chrome_trace(os.path.join(output_dir, "traces", name))
    return None
