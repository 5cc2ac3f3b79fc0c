"""Serving launcher: the online detection service and batched LM decode
(port of ``repro/launch/serve.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch fedyolov3 --full-size --img-size 416
  PYTHONPATH=src python -m repro_torch.launch.serve --arch fedyolov3 --store /tmp/cos
  PYTHONPATH=src python -m repro_torch.launch.serve --arch fedyolov3 --one-shot
  PYTHONPATH=src python -m repro_torch.launch.serve --arch fedyolov3 --img-size 32 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b --full-size --prompt-len 1024
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b --device cpu

yolo-family archs serve detections: the default mode stands up
``core.serving.InferenceService`` on a socket, drives ``--requests``
synthetic requests through an ``InferenceClient`` and prints the
QPS/latency/freshness summary as one JSON line. ``--store`` / ``--task-id``
restore the federated model from a COS store written by either package,
published at the stored round version. ``--one-shot`` decodes one batch and
exits. LM archs of every family prefill ``--batch`` random prompts of
``--prompt-len`` tokens (a vlm arch behind ``n_image_tokens`` random image
embeddings) and decode ``--new-tokens`` more (greedy, or sampled at
``--temperature``), with ``attention_impl`` and ``ssm_impl`` set to
``"kernel"``: flash attention (K9) and the SSD chunk scan (K10) run in the
prefill on the card, their plain versions on the CPU. An encoder-only arch
(hubert-xlarge) has no decode step and is refused, as the reference
refuses it. ``--arch`` defaults to qwen3-1.7b, as the reference's does.
``--device`` defaults to ``cuda`` and never falls back to the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch import device as D
from repro_torch.checkpoint import ObjectStore
from repro_torch.configs import get_arch
from repro_torch.models.yolov3 import FedYOLOv3


def generate(cfg, params, prompts: torch.Tensor, new_tokens: int, temperature: float = 0.0,
             generator: torch.Generator | None = None,
             images: torch.Tensor | None = None) -> torch.Tensor:
    """prompts (B, S) int -> (B, new_tokens) int64: prefill with the cache
    sized for ``ni + S + new_tokens``, then one ``decode_step`` per new
    token at positions from ``ni + S``; greedy at ``temperature`` 0, else
    sampled from ``generator``. A vlm config takes ``images`` (B, ni,
    d_model), ni its ``n_image_tokens``, prepended to the prompts."""
    from repro_torch.models import serving as MS

    B, Sq = prompts.shape
    ni = cfg.n_image_tokens if cfg.modality == "vlm" else 0
    batch = {"tokens": prompts}
    if ni:
        batch["images"] = images
    with torch.inference_mode():
        logits, cache = MS.prefill(cfg, params, batch, max_len=ni + Sq + new_tokens)
        tok = logits[:, -1].argmax(-1, keepdim=True)
        out = []
        for i in range(new_tokens):
            out.append(tok)
            logits, cache = MS.decode_step(cfg, params, cache, tok, ni + Sq + i)
            if temperature > 0:
                probs = torch.softmax(logits[:, -1].float() / temperature, dim=-1)
                tok = torch.multinomial(probs, 1, generator=generator)
            else:
                tok = logits[:, -1].argmax(-1, keepdim=True)
    return torch.cat(out, dim=1)


def lm_params(cfg, dev: torch.device):
    """Random float32 weights from seed 0, drawn on ``dev`` (a full-width
    model is drawn by the card, not by 1.7 B host ``randn`` calls)."""
    from repro_torch.models import params as P
    from repro_torch.models import transformer as T

    return P.init_params(T.template(cfg), torch.Generator(device=dev).manual_seed(0))


def lm_inputs(cfg, batch: int, prompt_len: int, dev: torch.device):
    """The launcher's random inputs, as the reference's launcher draws them
    from ``default_rng(0)``: prompts (batch, prompt_len), then for a vlm
    arch image embeddings (batch, n_image_tokens, d_model) float32, else
    None."""
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, prompt_len))).to(dev)
    images = None
    if cfg.modality == "vlm":
        images = torch.from_numpy(
            (rng.normal(size=(batch, cfg.n_image_tokens, cfg.d_model)) * 0.1).astype(np.float32)
        ).to(dev)
    return prompts, images


def serve_lm(cfg, args, dev: torch.device, params=None) -> dict:
    """Prefill random prompts (:func:`lm_inputs`) and decode; print and
    return the JSON summary. ``params`` default to :func:`lm_params`."""
    cfg = dataclasses.replace(cfg, attention_impl="kernel", ssm_impl="kernel")
    if params is None:
        params = lm_params(cfg, dev)
    prompts, images = lm_inputs(cfg, args.batch, args.prompt_len, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    toks = generate(cfg, params, prompts, args.new_tokens, args.temperature, gen, images)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    summary = {
        "arch": cfg.name,
        "generated": toks[0].tolist(),
        "tokens_per_s": round(args.batch * args.new_tokens / dt, 2),
        "device": _device_name(dev),
    }
    print(json.dumps(summary))
    return summary


def restore_params(cfg, args, device: torch.device):
    """COS restore -> (model on ``device``, round version). Without a store
    the weights are the port's own init from seed 0, version 0."""
    model = FedYOLOv3(cfg, torch.Generator().manual_seed(0))
    version = 0
    if args.store:
        store = ObjectStore(args.store)
        version = max(store.rounds(args.task_id))
        store.restore_into(args.task_id, model)
    return model.to(device).eval(), version


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def serve_detection(cfg, args, dev: torch.device) -> None:
    """--one-shot: decode one synthetic batch -> box list JSON, exit."""
    from repro_torch.core import detection
    from repro_torch.data import synthetic

    model, _ = restore_params(cfg, args, dev)
    rng = np.random.default_rng(7)
    imgs, _ = synthetic.scene_images(rng, args.batch, args.img_size, cfg.vocab_size)
    t0 = time.perf_counter()
    with torch.inference_mode():
        pred = detection.decode_predictions(
            cfg, model, torch.from_numpy(imgs).to(dev), max_detections=args.max_detections
        )
        valid, cls, scores, boxes = (pred[k].cpu().numpy() for k in ("valid", "cls", "scores", "boxes"))
    dt = time.perf_counter() - t0
    detections = [
        [
            {
                "label": int(cls[b, k]),
                "score": round(float(scores[b, k]), 4),
                "box": [round(float(v), 4) for v in boxes[b, k]],
            }
            for k in np.nonzero(valid[b])[0]
        ]
        for b in range(args.batch)
    ]
    print(json.dumps({
        "arch": cfg.name,
        "device": _device_name(dev),
        "restored": bool(args.store),
        "detections": detections,
        "images_per_s": round(args.batch / dt, 2),
    }))


def serve_service(cfg, args, dev: torch.device) -> None:
    """Stand up the socket service, drive --requests synthetic requests one
    at a time, print the operational summary."""
    from repro_torch.core import rounds as R
    from repro_torch.core import serving
    from repro_torch.data import synthetic

    fed = R.FedConfig(
        n_clients=1,
        serve_batch=args.serve_batch,
        serve_max_detections=args.max_detections,
    )
    model, version = restore_params(cfg, args, dev)
    slot = serving.ModelSlot()
    slot.publish(version, model)
    svc = serving.InferenceService(
        cfg, fed, slot, img_size=args.img_size, port=args.port, device=dev
    ).start()
    try:
        rng = np.random.default_rng(7)
        imgs, _ = synthetic.scene_images(rng, args.requests, args.img_size, cfg.vocab_size)
        # warm the program (first cuDNN/kernel use) so set-up stays out of the latencies
        with serving.InferenceClient(svc.host, svc.port) as warm:
            warm.infer(imgs[0])
        lat = []
        t0 = time.perf_counter()
        with serving.InferenceClient(svc.host, svc.port) as client:
            for i in range(args.requests):
                t1 = time.perf_counter()
                res = client.infer(imgs[i])
                lat.append(time.perf_counter() - t1)
            total = time.perf_counter() - t0
            status = client.status()
    finally:
        svc.stop()
    lat.sort()
    print(json.dumps({
        "arch": cfg.name,
        "device": _device_name(dev),
        "restored": bool(args.store),
        "version": status["version"],
        "tier": status["tier"],
        "requests": args.requests,
        "dropped": status["in_flight"],
        "qps": round(args.requests / total, 2),
        "p50_ms": round(lat[len(lat) // 2] * 1e3, 3),
        "p99_ms": round(lat[min(len(lat) - 1, int(len(lat) * 0.99))] * 1e3, 3),
        "avg_occupancy": status["avg_occupancy"],
        "last_detections": len(res.detections),
    }))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu; no fallback")
    ap.add_argument("--batch", type=int, default=4, help="LM prompts; --one-shot: images decoded")
    ap.add_argument("--prompt-len", type=int, default=32, help="LM: prompt tokens")
    ap.add_argument("--new-tokens", type=int, default=16, help="LM: tokens decoded")
    ap.add_argument("--temperature", type=float, default=0.0, help="LM: 0 = greedy")
    ap.add_argument("--img-size", type=int, default=64, help="served image size")
    ap.add_argument("--max-detections", type=int, default=16, help="NMS output slots")
    ap.add_argument("--store", default="", help="COS dir to restore the federated model from")
    ap.add_argument("--task-id", default="fedyolo", help="COS task id (with --store)")
    ap.add_argument("--one-shot", action="store_true",
                    help="decode one synthetic batch and exit")
    ap.add_argument("--port", type=int, default=0, help="service port (0 = ephemeral)")
    ap.add_argument("--requests", type=int, default=8,
                    help="service: synthetic requests to drive through the socket")
    ap.add_argument("--serve-batch", type=int, default=8,
                    help="service: batch slots of the decode+NMS program")
    ap.add_argument("--full-size", action="store_true",
                    help="use the full config (must match how the stored model was trained)")
    return ap


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)

    try:
        cfg = get_arch(args.arch)
    except KeyError as e:
        raise SystemExit(e.args[0]) from None
    if not args.full_size:
        cfg = cfg.reduced()
    if cfg.family != "yolo" and not cfg.has_decode:
        raise SystemExit(f"{args.arch} is encoder-only: no decode step (DESIGN.md)")
    dev = D.resolve(args.device)
    if cfg.family != "yolo":
        serve_lm(cfg, args, dev)
    elif args.one_shot:
        serve_detection(cfg, args, dev)
    else:
        serve_service(cfg, args, dev)


if __name__ == "__main__":
    main()
