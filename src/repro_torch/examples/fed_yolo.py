"""FedYOLOv3, the paper's headline application, end to end: train ->
evaluate -> serve (port of ``examples/fed_yolo.py``).

    PYTHONPATH=src python -m repro_torch.examples.fed_yolo [--rounds 30] [--device cpu]

Data owners hold procedurally generated camera scenes annotated in the
paper's Darknet ``{label x y w h}`` format, split non-IID (dirichlet label
skew, which also skews box scale). Each round the Task Scheduler selects
participants (masked participation: the straggler load model keeps
overloaded cameras out), the selected clients train YOLOv3 locally (the
Eqs. 2-4 loss), upload their Eq. 6 top-n layers through the registry
aggregator (K1 on the card), and the server aggregates (Eq. 5) and stores
the round model in the COS object store every 5 rounds. Every
``--eval-every`` rounds ``server.evaluate_round`` scores the global model
on each client's holdout (mAP@0.5 through the IoU and NMS kernels) and
feeds the per-client quality back into the scheduler. The finale decodes 4
frames from the final global model as the serving plane does. The server
runs on the launcher's 1 x 1 client mesh, as the reference's example does.
``--device`` defaults to ``cuda``; ``cpu`` runs the kernels' plain
versions.
"""
from __future__ import annotations

import argparse
import tempfile
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import device as D
from repro_torch.checkpoint import ObjectStore
from repro_torch.configs import get_arch
from repro_torch.core import detection, monitor
from repro_torch.core.rounds import FedConfig
from repro_torch.core.scheduler import SchedulerConfig, TaskScheduler
from repro_torch.core.server import FLServer
from repro_torch.data import darknet, synthetic
from repro_torch.data.pipeline import detection_suite
from repro_torch.launch.train import client_mesh
from repro_torch.models import yolov3
from repro_torch.optim import sgd


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--clients", type=int, default=3)
    ap.add_argument("--img-size", type=int, default=64)
    ap.add_argument("--eval-every", type=int, default=5)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu; no fallback")
    return ap


def main(argv: list[str] | None = None,
         log: Callable[[str], None] = lambda m: print(m, flush=True)) -> dict[str, Any]:
    """Run the example -> what it printed, as values: the mapped file
    count, the split sizes, the loss trajectory, the COS rounds, the served
    detections, and the server."""
    args = build_parser().parse_args(argv)
    dev = D.resolve(args.device)
    cfg = get_arch("fedyolov3")
    fed = FedConfig(n_clients=args.clients, local_steps=1, aggregation="eq6", topn=4,
                    client_axis="data", data_axis=None, participation="masked",
                    agg_impl="kernel")

    with tempfile.TemporaryDirectory() as tmp:
        # --- crowdsourced annotation flow: clients write Darknet rows ---------
        rng = np.random.default_rng(0)
        _, boxes = synthetic.scene_images(rng, 4, args.img_size, cfg.vocab_size)
        cam = Path(tmp) / "cam0"
        cam.mkdir()
        for i, bs in enumerate(boxes):
            (cam / f"frame{i}.txt").write_text(darknet.write_annotation(bs))
        mapped = darknet.map_annotations(cam, Path(tmp) / "train")
        log(f"annotation module mapped {len(mapped)} files into the training dir")

        # --- train: non-IID scene pool + scheduler-in-the-loop rounds -----
        gen, eval_batch, stats = detection_suite(cfg, fed, batch=2, img_size=args.img_size,
                                                 scenario="dirichlet")
        log(f"dirichlet scene split: sizes {stats['label']['sizes']}, "
            f"box-scale spread {stats['scale']['spread']:.2f}x across clients")
        store = ObjectStore(Path(tmp) / "cos")
        server = FLServer(
            cfg, fed, sgd(lr=1e-3), store=store, mesh=client_mesh(dev),
            scheduler=TaskScheduler(args.clients, SchedulerConfig(
                max_participants=max(2, args.clients - 1), fairness_rounds=3)),
            checkpoint_every=5, task_id="fedyolo", device=dev,
        )
        for r in range(args.rounds):
            server.run_round(next(gen))
            if r % args.eval_every == 0 or r == args.rounds - 1:
                ev = server.evaluate_round(eval_batch)
                per = " ".join(f"{m:.3f}" for m in ev.per_client_map)
                log(f"round {r:3d}  loss {server.history[-1].loss:8.3f}  "
                    f"mAP@0.5 {ev.map50:.3f}  per-client [{per}]")
        history = server.history
        log(monitor.render_task("fedyolo", history, args.clients,
                                eval_history=server.eval_history))

        # --- serve: final global model -> decode + NMS ---------------------
        model = server.global_params()
        imgs_t, boxes_t = synthetic.scene_images(np.random.default_rng(7), 4, args.img_size,
                                                 cfg.vocab_size)
        imgs = torch.from_numpy(imgs_t).to(dev)
        with torch.inference_mode():
            pred = detection.decode_predictions(cfg, model, imgs, max_detections=16)
            kept = int(pred["valid"].sum())
            log(f"serving 4 frames: {kept} detections after NMS "
                f"(top score {float(pred['scores'].max()):.3f})")

            # detection sanity: confidence at object cells > empty cells
            outs = model(imgs)
            grids = yolov3.grid_sizes(cfg, args.img_size)
            tgts = darknet.build_targets(boxes_t, grids, cfg.n_heads, cfg.vocab_size,
                                         yolov3.ANCHORS)
            _, conf, _ = yolov3.decode_boxes(outs[0].float(), yolov3.ANCHORS[0])
            obj = torch.from_numpy(tgts[0]["obj"]).to(dev)
            conf_obj = float((conf * obj).sum() / torch.clamp_min(obj.sum(), 1))
            conf_bg = float((conf * (1 - obj)).sum() / (1 - obj).sum())
        log(f"loss {history[0].loss:.3f} -> {history[-1].loss:.3f}; "
            f"mean conf@objects={conf_obj:.3f} vs background={conf_bg:.3f}")
        stored = store.rounds("fedyolo")
        log(f"COS stored rounds: {stored}, total {store.total_bytes() / 1e6:.2f} MB")
        if not history[-1].loss < history[0].loss:
            raise RuntimeError(f"the loss did not fall: {history[0].loss} -> {history[-1].loss}")
    return {"mapped": len(mapped), "sizes": stats["label"]["sizes"],
            "losses": [r.loss for r in history], "stored_rounds": stored,
            "served_detections": kept, "server": server}


if __name__ == "__main__":
    main()
    import torch.distributed as dist

    if dist.is_initialized():  # the 1 x 1 client mesh's one-rank group
        dist.destroy_process_group()
