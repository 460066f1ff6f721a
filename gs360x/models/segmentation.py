"""Flax segmentation network — the device subject-masking model.

Replaces the reference's torchvision Mask R-CNN inference
(``/root/reference/cli_tools/gs360_SegmentationMaskTool.py:262-332,
666-677``) with a JAX/Flax semantic-segmentation U-Net over the tool's
target classes. Instances are recovered from the class probability maps by
connected-component analysis with per-instance mean-probability scores, and
the downstream contract is preserved exactly: score threshold 0.7, mask
threshold 0.5, ≤15 detections per image (the reference's tuning constants).

Mask R-CNN's value in the reference comes entirely from its pretrained COCO
weights (torchvision downloads them); equivalently, this model loads
pretrained parameters from an Orbax checkpoint (``--checkpoint``). A
from-scratch training step (:func:`train_step`, optax AdamW, softmax
cross-entropy with class weighting) is provided for fine-tuning and for the
multi-chip training dry run.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from flax import linen as nn

# class table: background + the mask tool's supported targets
CLASS_NAMES = ("background", "person", "bicycle", "car", "motorcycle",
               "bus", "truck", "bird", "cat", "dog")
NUM_CLASSES = len(CLASS_NAMES)
CLASS_TO_INDEX = {name: i for i, name in enumerate(CLASS_NAMES)}

# inference contract constants (reference gs360_SegmentationMaskTool.py:48-54)
SCORE_THRESH = 0.7
MASK_THRESH = 0.5
DETECTIONS_PER_IMG = 15
MIN_SIZE = 640
MAX_SIZE = 1024

# COCO label ids for the targets (reference table :75-195)
TARGET_TO_CLASSES = {
    "person": ["person"],
    "bicycle": ["bicycle"],
    "car": ["car"],
    "motorcycle": ["motorcycle"],
    "bus": ["bus"],
    "truck": ["truck"],
    "animal": ["bird", "cat", "dog"],
}


class ConvBlock(nn.Module):
    features: int

    @nn.compact
    def __call__(self, x, train: bool = False):
        x = nn.Conv(self.features, (3, 3), padding="SAME")(x)
        x = nn.GroupNorm(num_groups=min(8, self.features))(x)
        x = nn.relu(x)
        x = nn.Conv(self.features, (3, 3), padding="SAME")(x)
        x = nn.GroupNorm(num_groups=min(8, self.features))(x)
        return nn.relu(x)


class UNet(nn.Module):
    """Encoder/decoder segmentation net with skip connections.

    bfloat16-friendly conv stacks sized so every level keeps lane-aligned
    channel counts; input (B, H, W, 3) float in [0,1], output per-pixel
    class logits (B, H, W, NUM_CLASSES). H and W must be multiples of 16.
    """

    features: Sequence[int] = (32, 64, 128, 256)
    num_classes: int = NUM_CLASSES

    @nn.compact
    def __call__(self, x, train: bool = False):
        skips = []
        for f in self.features[:-1]:
            x = ConvBlock(f)(x, train)
            skips.append(x)
            x = nn.max_pool(x, (2, 2), strides=(2, 2))
        x = ConvBlock(self.features[-1])(x, train)
        for f, skip in zip(reversed(self.features[:-1]), reversed(skips)):
            b, h, w, c = x.shape
            x = jax.image.resize(x, (b, h * 2, w * 2, c), "nearest")
            x = nn.Conv(f, (3, 3), padding="SAME")(x)
            x = jnp.concatenate([x, skip], axis=-1)
            x = ConvBlock(f)(x, train)
        return nn.Conv(self.num_classes, (1, 1))(x)


def create_model(features=None) -> UNet:
    return UNet() if features is None else UNet(features=tuple(features))


def init_params(rng: jax.Array, input_size: int = 256, features=None):
    model = create_model(features)
    dummy = jnp.zeros((1, input_size, input_size, 3), jnp.float32)
    return model.init(rng, dummy)["params"]


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------


def create_train_state(rng: jax.Array, learning_rate: float = 1e-3,
                       input_size: int = 256, features=None,
                       decay_steps: int = 0):
    """``decay_steps`` > 0 runs cosine decay (with a 5% linear warmup)
    to 10% of the peak rate over that many steps — flat-rate AdamW left
    some seeds visibly under-converged at the same budget."""
    import optax
    from flax.training import train_state

    params = init_params(rng, input_size, features)
    if decay_steps:
        warm = max(1, decay_steps // 20)
        sched = optax.warmup_cosine_decay_schedule(
            init_value=learning_rate * 0.1, peak_value=learning_rate,
            warmup_steps=warm, decay_steps=decay_steps,
            end_value=learning_rate * 0.1)
        tx = optax.adamw(sched)
    else:
        tx = optax.adamw(learning_rate)
    return train_state.TrainState.create(
        apply_fn=create_model(features).apply, params=params, tx=tx)


@functools.partial(jax.jit, static_argnames=("fg_weight",))
def train_step(state, images: jnp.ndarray, labels: jnp.ndarray,
               fg_weight: float = 1.0):
    """One optimization step. ``images``: (B,H,W,3) float; ``labels``:
    (B,H,W) int class ids. Returns (new_state, loss). ``fg_weight`` > 1
    up-weights non-background pixels (subjects typically cover ~10% of a
    frame, so unweighted CE under-predicts foreground)."""

    def loss_fn(params):
        logits = state.apply_fn({"params": params}, images, train=True)
        onehot = jax.nn.one_hot(labels, NUM_CLASSES)
        ce = -jnp.sum(onehot * jax.nn.log_softmax(logits), axis=-1)
        if fg_weight != 1.0:
            w = jnp.where(labels > 0, fg_weight, 1.0)
            return jnp.sum(ce * w) / jnp.sum(w)
        return jnp.mean(ce)

    loss, grads = jax.value_and_grad(loss_fn)(state.params)
    return state.apply_gradients(grads=grads), loss


# --------------------------------------------------------------------------
# checkpointing
# --------------------------------------------------------------------------


def save_checkpoint(path, params) -> None:
    import orbax.checkpoint as ocp

    ckptr = ocp.StandardCheckpointer()
    ckptr.save(str(path), params, force=True)
    ckptr.wait_until_finished()


def load_checkpoint(path, template_params=None):
    import orbax.checkpoint as ocp

    ckptr = ocp.StandardCheckpointer()
    if template_params is None:
        template_params = init_params(jax.random.key(0))
    return ckptr.restore(str(path),
                         target=jax.tree.map(np.asarray, template_params))


def save_weights(path, params) -> None:
    """Single-file msgpack weights — the SHIPPED-checkpoint format.

    The reference ships its capability as pretrained COCO weights
    (torchvision download, gs360_SegmentationMaskTool.py:262-288); the
    repo equivalently ships ``gs360x/models/weights/*.msgpack`` trained
    by ``tools/seg_eval.py`` so inference never retrains.  Orbax
    (:func:`save_checkpoint`) remains the working-directory format for
    ``segtrain``/fine-tuning; msgpack is for the committed artifact
    (one file, stable across platforms, ~0.5 MB at the default width).
    """
    from flax import serialization

    with open(path, "wb") as f:
        f.write(serialization.to_bytes(params))


def load_weights(path, template_params=None):
    from flax import serialization

    if template_params is None:
        template_params = init_params(jax.random.key(0))
    with open(path, "rb") as f:
        return serialization.from_bytes(template_params, f.read())


# --------------------------------------------------------------------------
# inference
# --------------------------------------------------------------------------


def features_from_params(params) -> Tuple[int, ...]:
    """Recover the U-Net width tuple from a params pytree (the encoder
    ConvBlocks' out-channels).  Lets one predictor serve checkpoints of
    any width — the shipped msgpack weights are narrower than the
    default net."""
    blocks = sorted((k for k in params if str(k).startswith("ConvBlock_")),
                    key=lambda k: int(str(k).split("_")[1]))
    n_enc = (len(blocks) + 1) // 2          # encoder + bottleneck
    return tuple(int(np.shape(params[b]["Conv_0"]["kernel"])[-1])
                 for b in blocks[:n_enc])


@functools.partial(jax.jit, static_argnames=("features",))
def _apply(params, image: jnp.ndarray, features=None) -> jnp.ndarray:
    logits = create_model(features).apply({"params": params}, image[None])
    return jax.nn.softmax(logits, axis=-1)[0]


def inference_size(h: int, w: int, min_size: int = MIN_SIZE,
                   max_size: int = MAX_SIZE) -> Tuple[int, int]:
    """Reference-compatible resize rule (short side → 640, long ≤ 1024),
    rounded to multiples of 16 for the U-Net."""
    scale = min_size / min(h, w)
    if max(h, w) * scale > max_size:
        scale = max_size / max(h, w)
    nh = max(16, int(round(h * scale / 16)) * 16)
    nw = max(16, int(round(w * scale / 16)) * 16)
    return nh, nw


class SegmentationPredictor:
    """End-to-end predictor: resize → U-Net → instance extraction."""

    def __init__(self, params=None, *, rng_seed: int = 0):
        if params is None:
            params = init_params(jax.random.key(rng_seed))
        self.params = params
        self._features = features_from_params(params)

    def class_probabilities(self, rgb01: np.ndarray) -> np.ndarray:
        h, w = rgb01.shape[:2]
        nh, nw = inference_size(h, w)
        img = jax.image.resize(jnp.asarray(rgb01, jnp.float32),
                               (nh, nw, 3), "linear")
        probs = _apply(self.params, img, features=self._features)
        probs = jax.image.resize(probs, (h, w, NUM_CLASSES), "linear")
        return np.asarray(probs)

    def detect(self, rgb01: np.ndarray, target_classes: Sequence[str], *,
               score_thresh: float = SCORE_THRESH,
               mask_thresh: float = MASK_THRESH,
               max_detections: int = DETECTIONS_PER_IMG) -> List[dict]:
        """Instance list [{'mask' (H,W) bool, 'score', 'class_name'}],
        score-sorted, capped at max_detections.

        Touching subjects are split by distance-transform watershed
        (:mod:`gs360x.models.instances`), recovering the per-detection
        granularity of the reference's Mask R-CNN output
        (gs360_SegmentationMaskTool.py:334-356)."""
        from gs360x.models.instances import instance_masks

        probs = self.class_probabilities(rgb01)
        detections = []
        for name in target_classes:
            ci = CLASS_TO_INDEX.get(name)
            if ci is None:
                continue
            p = probs[..., ci]
            binary = p >= mask_thresh
            if not binary.any():
                continue
            for det in instance_masks(binary, p,
                                      score_thresh=score_thresh,
                                      max_count=max_detections):
                det["class_name"] = name
                detections.append(det)
        detections.sort(key=lambda d: -d["score"])
        return detections[:max_detections]

    def combined_mask(self, rgb01: np.ndarray,
                      target_classes: Sequence[str], **kw) -> Optional[np.ndarray]:
        """Union of detected instance masks as uint8 {0,255}, or None."""
        dets = self.detect(rgb01, target_classes, **kw)
        if not dets:
            return None
        out = np.zeros(rgb01.shape[:2], bool)
        for d in dets:
            out |= d["mask"]
        return out.astype(np.uint8) * 255
