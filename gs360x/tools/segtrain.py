"""gs360x-segtrain — train the segmentation U-Net on labeled masks.

The reference ships no training path: it downloads torchvision's
COCO-pretrained Mask R-CNN (``gs360_SegmentationMaskTool.py:262-288``),
which an offline deployment cannot. This tool closes that loop: given
a folder of images and a folder of same-stem mask PNGs (pixel value =
class id, see :data:`gs360x.models.segmentation.TARGET_TO_CLASSES`; any
nonzero value in a single-target dataset maps to the chosen class), it
trains the U-Net with data parallelism over every visible device and
writes an Orbax checkpoint consumable by ``gs360x-maskseg --checkpoint``.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time
from typing import List, Optional, Tuple

import numpy as np

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".tif", ".tiff")


def find_pairs(image_dir: pathlib.Path, mask_dir: pathlib.Path
               ) -> List[Tuple[pathlib.Path, pathlib.Path]]:
    """Match images to masks by stem (mask extension may differ)."""
    masks = {}
    for p in sorted(mask_dir.iterdir()):
        if p.suffix.lower() in IMAGE_EXTS:
            masks.setdefault(p.stem, p)
    pairs = []
    for p in sorted(image_dir.iterdir()):
        if p.suffix.lower() in IMAGE_EXTS and p.stem in masks:
            pairs.append((p, masks[p.stem]))
    return pairs


def load_pair(img_path, mask_path, size: int, target_class: Optional[int]
              ) -> Tuple[np.ndarray, np.ndarray]:
    from gs360x.io.image import read_image, to_float01

    img = to_float01(read_image(img_path))
    mask = read_image(mask_path)
    if mask.ndim == 3:
        mask = mask[..., 0]
    img = resize_bilinear_np(img, size, size)
    sh, sw = mask.shape
    ys = np.minimum(((np.arange(size) + 0.5) * sh / size).astype(np.int64),
                    sh - 1)
    xs = np.minimum(((np.arange(size) + 0.5) * sw / size).astype(np.int64),
                    sw - 1)
    mask = mask[ys][:, xs]
    if target_class is not None:
        mask = np.where(mask > 0, target_class, 0)
    return img.astype(np.float32), mask.astype(np.int32)


def resize_bilinear_np(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Host bilinear resize (training data prep; no cv2 dependency)."""
    sh, sw = img.shape[:2]
    if (sh, sw) == (h, w):
        return img
    ys = (np.arange(h) + 0.5) * sh / h - 0.5
    xs = (np.arange(w) + 0.5) * sw / w - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, sh - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, sw - 1)
    y1 = np.minimum(y0 + 1, sh - 1)
    x1 = np.minimum(x0 + 1, sw - 1)
    fy = np.clip(ys - y0, 0.0, 1.0)[:, None, None]
    fx = np.clip(xs - x0, 0.0, 1.0)[None, :, None]
    a = img[y0][:, x0]
    b = img[y0][:, x1]
    c = img[y1][:, x0]
    d = img[y1][:, x1]
    return (a * (1 - fy) * (1 - fx) + b * (1 - fy) * fx
            + c * fy * (1 - fx) + d * fy * fx)


def build_arg_parser() -> argparse.ArgumentParser:
    from gs360x.models import segmentation as seg

    ap = argparse.ArgumentParser(
        description="Train the gs360x segmentation U-Net on labeled masks.")
    ap.add_argument("--make-default", action="store_true",
                    help="Build the synthetic-corpus default checkpoint "
                         "used by gs360x-maskseg when no --checkpoint is "
                         "given (cached in ~/.cache/gs360x)")
    ap.add_argument("-i", "--image-dir", required=False, default=None)
    ap.add_argument("-m", "--mask-dir", required=False, default=None,
                    help="Same-stem mask PNGs (pixel value = class id)")
    ap.add_argument("-o", "--checkpoint", required=False, default=None,
                    help="Output Orbax checkpoint directory")
    ap.add_argument("--resume", default=None,
                    help="Existing checkpoint to fine-tune from")
    ap.add_argument("--target", choices=sorted(seg.TARGET_TO_CLASSES),
                    default=None,
                    help="Binary dataset: map all nonzero mask pixels to "
                         "this target's first class id")
    ap.add_argument("--size", type=int, default=256,
                    help="Training crop/resize (default 256)")
    ap.add_argument("--batch-size", type=int, default=8,
                    help="Global batch (split over devices)")
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--val-fraction", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None) -> int:
    try:
        return _main(argv)
    except KeyboardInterrupt:
        # reference contract: SIGINT stops cleanly with exit code 130
        print("\n[INFO] Interrupt received, stopping...", file=sys.stderr)
        return 130


def _main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    if args.make_default:
        from gs360x.models import synthseg
        path = (pathlib.Path(args.checkpoint).resolve() if args.checkpoint
                else synthseg.default_checkpoint_path())
        synthseg.build_default_checkpoint(path)
        return 0
    if not (args.image_dir and args.mask_dir and args.checkpoint):
        print("[ERR] -i/--image-dir, -m/--mask-dir and -o/--checkpoint are "
              "required (or use --make-default)", file=sys.stderr)
        return 2
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    from gs360x.models import segmentation as seg
    from gs360x.runtime.mesh import data_mesh

    image_dir = pathlib.Path(args.image_dir)
    mask_dir = pathlib.Path(args.mask_dir)
    pairs = find_pairs(image_dir, mask_dir)
    if len(pairs) < 2:
        print(f"[ERR] need >=2 image/mask pairs, found {len(pairs)} "
              f"(images: {image_dir}, masks: {mask_dir})", file=sys.stderr)
        return 1

    target_class = None
    if args.target:
        target_class = seg.CLASS_TO_INDEX[
            seg.TARGET_TO_CLASSES[args.target][0]]

    print(f"[INFO] {len(pairs)} pairs, size {args.size}, "
          f"devices {jax.device_count()}")
    rng = np.random.default_rng(args.seed)
    order = rng.permutation(len(pairs))
    n_val = max(1, int(len(pairs) * args.val_fraction)) \
        if len(pairs) >= 10 else 0
    val_idx = set(order[:n_val].tolist())

    images, labels, val_images, val_labels = [], [], [], []
    for k, (ip, mp) in enumerate(pairs):
        try:
            img, mask = load_pair(ip, mp, args.size, target_class)
        except Exception as exc:
            print(f"[WARN] skip {ip.name}: {exc}", file=sys.stderr)
            continue
        (val_images if k in val_idx else images).append(img)
        (val_labels if k in val_idx else labels).append(mask)
    if not images:
        print("[ERR] no loadable pairs", file=sys.stderr)
        return 1
    images = np.stack(images)
    labels = np.stack(labels)
    print(f"[INFO] train {len(images)}, val {len(val_images)}")

    state = seg.create_train_state(jax.random.key(args.seed),
                                   learning_rate=args.lr,
                                   input_size=args.size)
    if args.resume:
        params = seg.load_checkpoint(pathlib.Path(args.resume).resolve(),
                                     template_params=state.params)
        state = state.replace(params=params)
        print(f"[INFO] resumed from {args.resume}")

    # data parallelism: shard the batch axis over every visible device
    mesh = data_mesh()
    batch_sharding = NamedSharding(mesh, PartitionSpec("data"))
    n_dev = jax.device_count()
    bs = max(n_dev, (args.batch_size // n_dev) * n_dev)

    steps_per_epoch = max(1, len(images) // bs)
    t0 = time.time()
    for epoch in range(args.epochs):
        perm = rng.permutation(len(images))
        losses = []
        for s in range(steps_per_epoch):
            idx = perm[s * bs:(s + 1) * bs]
            if len(idx) < bs:  # pad the tail batch by wrapping
                idx = np.concatenate([idx, perm[:bs - len(idx)]])
            xb = jax.device_put(jnp.asarray(images[idx]), batch_sharding)
            yb = jax.device_put(jnp.asarray(labels[idx]), batch_sharding)
            state, loss = seg.train_step(state, xb, yb)
            losses.append(float(loss))
        msg = (f"[INFO] epoch {epoch + 1}/{args.epochs} "
               f"loss {np.mean(losses):.4f}")
        if len(val_images):
            acc = _pixel_accuracy(seg, state.params,
                                  np.stack(val_images),
                                  np.stack(val_labels))
            msg += f" val_acc {acc:.3f}"
        print(msg, flush=True)

    out = pathlib.Path(args.checkpoint).expanduser().resolve()
    seg.save_checkpoint(out, jax.device_get(state.params))
    print(f"[OK] checkpoint: {out} ({time.time() - t0:.1f}s)")
    return 0


def _pixel_accuracy(seg, params, images: np.ndarray,
                    labels: np.ndarray) -> float:
    import jax.numpy as jnp

    logits = seg.create_model().apply({"params": params},
                                      jnp.asarray(images))
    pred = np.asarray(jnp.argmax(logits, axis=-1))
    return float((pred == labels).mean())


if __name__ == "__main__":
    sys.exit(main())
