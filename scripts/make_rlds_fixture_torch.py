#!/usr/bin/env python3
"""Write the small RLDS fixture that the port's data layer and training CLIs
read: a TFDS-layout ``bridge_orig/1.0.0`` directory (``features.json``,
``dataset_info.json`` and TFRecord shards of tf.Example episodes), laid out
as ``tests/fixtures.py:make_bridge_like_dataset`` lays its own out, at
bridge_orig's 256 x 256 frames.

    python scripts/make_rlds_fixture_torch.py --out tests/fixtures_rlds [--seed 0]

Each episode has two camera views (``image_0``, the primary, and
``image_1``), a 7-D state and action a step, one instruction and a terminal
flag. The frames are smooth, made from ``--seed``: a low-frequency colour
field and a disk that moves across it over the episode, so the JPEGs stay
small. The records are written with the port's own
``data/tfrecord.write_records`` and ``data/example_proto.serialize_example``;
the JPEGs are encoded with PIL (quality 90), so this script needs PIL, and
what reads the fixture does not. Imports nothing of jax.

    python scripts/make_rlds_fixture_torch.py --subsampling tests/fixtures_rlds/subsampling.npz

writes instead one small smooth frame (67 x 101, a disk on a colour field)
as a JPEG at each chroma subsampling the decoders meet (4:4:4, 4:2:2,
4:2:0, 4:4:0, 4:1:1, 4:1:0 and grayscale; ``<kind>/jpeg``) beside PIL's decode of
it (``<kind>/rgb``), which tests hold both JPEG routes to. PIL encodes no
4:4:0, 4:1:1 or 4:1:0, so these JPEGs are encoded by a small C program against
libjpeg, compiled at run time with ``cc``.
"""
from __future__ import annotations

import argparse
import io
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from spatialvla_tpu_torch.data import example_proto, tfrecord  # noqa: E402

NAME, VERSION = "bridge_orig", "1.0.0"
FRAME_HW = (256, 256)
INSTRUCTIONS = (b"pick up the red cup", b"open the top drawer", b"put the spoon in the pot",
                b"move the block to the left of the bowl", b"close the microwave")


def _tensor(dtype, dims):
    return {"pythonClassName": "tensorflow_datasets.core.features.tensor_feature.Tensor",
            "tensor": {"shape": {"dimensions": [str(d) for d in dims]}, "dtype": dtype}}


def _image(h, w):
    return {"pythonClassName": "tensorflow_datasets.core.features.image_feature.Image",
            "image": {"shape": {"dimensions": [str(h), str(w), "3"]}, "dtype": "uint8",
                      "encodingFormat": "jpeg"}}


def _text():
    return {"pythonClassName": "tensorflow_datasets.core.features.text_feature.Text",
            "text": {}}


def _fdict(features):
    return {"pythonClassName": "tensorflow_datasets.core.features.features_dict.FeaturesDict",
            "featuresDict": {"features": features}}


def features_json(img_hw=FRAME_HW):
    """The schema of tests/fixtures.py:bridge_like_features_json."""
    h, w = img_hw
    steps = _fdict({
        "observation": _fdict({"image_0": _image(h, w), "image_1": _image(h, w),
                               "state": _tensor("float32", [7])}),
        "action": _tensor("float32", [7]),
        "language_instruction": _text(),
        "is_terminal": _tensor("bool", []),
    })
    return _fdict({
        "steps": {"pythonClassName":
                  "tensorflow_datasets.core.features.dataset_feature.Dataset",
                  "sequence": {"feature": steps}},
        "episode_metadata": _fdict({"file_path": _text()}),
    })


def smooth_frames(rng, n_steps, img_hw=FRAME_HW):
    """(n_steps, H, W, 3) uint8: a few low-frequency sinusoids a channel and
    a disk moving on a straight line over the episode."""
    h, w = img_hw
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    field = np.zeros((h, w, 3), np.float32)
    for c in range(3):
        for _ in range(3):
            fy, fx = rng.uniform(0.5, 2.5, 2) * 2 * np.pi / np.array([h, w])
            field[..., c] += rng.uniform(15, 35) * np.sin(fy * y + fx * x + rng.uniform(0, 2 * np.pi))
    field += rng.uniform(70, 180, 3)
    start, end = rng.uniform(0.2, 0.8, 2) * [h, w], rng.uniform(0.2, 0.8, 2) * [h, w]
    radius, colour = rng.uniform(18, 40), rng.uniform(0, 255, 3)
    frames = []
    for t in range(n_steps):
        cy, cx = start + (end - start) * t / max(n_steps - 1, 1)
        inside = ((y - cy) ** 2 + (x - cx) ** 2 <= radius ** 2)[..., None]
        frames.append(np.clip(np.where(inside, colour, field), 0, 255).astype(np.uint8))
    return np.stack(frames)


def jpeg(img: np.ndarray, quality: int = 90) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


# the luma sampling factors (h, v) of each kind; the chroma planes are 1 x 1
SUBSAMPLING = {"444": (1, 1), "422": (2, 1), "420": (2, 2), "440": (1, 2), "411": (4, 1),
               "410": (4, 2), "gray": None}
SUBSAMPLED_HW = (67, 101)  # odd sizes: partial chroma blocks at the right and bottom

_ENCODER = r"""
#include <stdio.h>
#include <stdlib.h>
#include <jpeglib.h>
/* encoder raw.bin H W C h v quality out.jpg: C = 1 (gray) or 3 (RGB), luma
   sampling h x v, chroma 1 x 1 */
int main(int argc, char** argv) {
  int H = atoi(argv[2]), W = atoi(argv[3]), C = atoi(argv[4]);
  unsigned char* px = malloc((size_t)H * W * C);
  FILE* in = fopen(argv[1], "rb");
  if (!in || fread(px, 1, (size_t)H * W * C, in) != (size_t)H * W * C) return 1;
  fclose(in);
  FILE* out = fopen(argv[8], "wb");
  if (!out) return 1;
  struct jpeg_compress_struct c;
  struct jpeg_error_mgr e;
  c.err = jpeg_std_error(&e);
  jpeg_create_compress(&c);
  jpeg_stdio_dest(&c, out);
  c.image_width = W;
  c.image_height = H;
  c.input_components = C;
  c.in_color_space = C == 1 ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_set_defaults(&c);
  jpeg_set_quality(&c, atoi(argv[7]), TRUE);
  c.comp_info[0].h_samp_factor = atoi(argv[5]);
  c.comp_info[0].v_samp_factor = atoi(argv[6]);
  for (int i = 1; i < c.num_components; i++)
    c.comp_info[i].h_samp_factor = c.comp_info[i].v_samp_factor = 1;
  jpeg_start_compress(&c, TRUE);
  while (c.next_scanline < c.image_height) {
    JSAMPROW row = px + (size_t)c.next_scanline * W * C;
    jpeg_write_scanlines(&c, &row, 1);
  }
  jpeg_finish_compress(&c);
  jpeg_destroy_compress(&c);
  fclose(out);
  return 0;
}
"""


def subsampled_jpegs(seed=0, quality=90):
    """{"<kind>/jpeg": the JPEG's bytes (uint8), "<kind>/rgb": PIL's decode
    of it (H, W, 3) uint8} for each kind of ``SUBSAMPLING``."""
    from PIL import Image

    frame = smooth_frames(np.random.RandomState(seed), 1, SUBSAMPLED_HW)[0]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        exe = os.path.join(tmp, "encode")
        with open(exe + ".c", "w") as f:
            f.write(_ENCODER)
        subprocess.run(["cc", "-O1", "-o", exe, exe + ".c", "-ljpeg"], check=True)
        for kind, factors in SUBSAMPLING.items():
            img = frame[..., 0] if factors is None else frame
            raw, path = os.path.join(tmp, "raw.bin"), os.path.join(tmp, kind + ".jpg")
            img.tofile(raw)
            h, v = factors or (1, 1)
            subprocess.run([exe, raw, *map(str, SUBSAMPLED_HW), "1" if factors is None else "3",
                            str(h), str(v), str(quality), path], check=True)
            data = open(path, "rb").read()
            out[kind + "/jpeg"] = np.frombuffer(data, np.uint8)
            out[kind + "/rgb"] = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    return out


def make_fixture(root, *, n_shards=2, episodes_per_shard=2, steps_per_episode=8, seed=0,
                 img_hw=FRAME_HW):
    """Writes ``<root>/bridge_orig/1.0.0``; returns that directory."""
    rng = np.random.RandomState(seed)
    ds_dir = os.path.join(root, NAME, VERSION)
    os.makedirs(ds_dir, exist_ok=True)
    with open(os.path.join(ds_dir, "features.json"), "w") as f:
        json.dump(features_json(img_hw), f)
    info = {"name": NAME, "version": VERSION,
            "splits": [{"name": "train", "shardLengths": [str(episodes_per_shard)] * n_shards}]}
    with open(os.path.join(ds_dir, "dataset_info.json"), "w") as f:
        json.dump(info, f)
    for s in range(n_shards):
        records = []
        for e in range(episodes_per_shard):
            T = steps_per_episode
            # a smooth state trajectory; the action is a delta and a gripper
            state = np.cumsum(rng.randn(T, 7).astype(np.float32) * 0.02, axis=0)
            state[:, 6] = (rng.rand(T) > 0.5).astype(np.float32)
            action = rng.randn(T, 7).astype(np.float32) * 0.05
            action[:, 6] = rng.choice([0.0, 1.0], T)
            views = [smooth_frames(rng, T, img_hw) for _ in range(2)]
            instruction = INSTRUCTIONS[rng.randint(len(INSTRUCTIONS))]
            feats = {
                "steps/observation/image_0": [jpeg(f) for f in views[0]],
                "steps/observation/image_1": [jpeg(f) for f in views[1]],
                "steps/observation/state": state.reshape(-1).tolist(),
                "steps/action": action.reshape(-1).tolist(),
                "steps/language_instruction": [instruction] * T,
                "steps/is_terminal": [0] * (T - 1) + [1],
                "episode_metadata/file_path": [f"/fixture/{s}/{e}".encode()],
            }
            records.append(example_proto.serialize_example(feats))
        tfrecord.write_records(
            os.path.join(ds_dir, f"{NAME}-train.tfrecord-{s:05d}-of-{n_shards:05d}"), records)
    return ds_dir


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", help="the data root (bridge_orig/1.0.0 goes under it)")
    p.add_argument("--subsampling", help="write the subsampled JPEGs to this .npz instead")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--shards", type=int, default=2)
    p.add_argument("--episodes_per_shard", type=int, default=2)
    p.add_argument("--steps", type=int, default=8)
    args = p.parse_args(argv)
    if args.subsampling:
        np.savez_compressed(args.subsampling, **subsampled_jpegs(args.seed))
        print(json.dumps({"subsampling": args.subsampling,
                          "bytes": os.path.getsize(args.subsampling)}))
        return
    if not args.out:
        p.error("--out or --subsampling is required")
    ds_dir = make_fixture(args.out, n_shards=args.shards,
                          episodes_per_shard=args.episodes_per_shard,
                          steps_per_episode=args.steps, seed=args.seed)
    total = sum(os.path.getsize(os.path.join(ds_dir, n)) for n in os.listdir(ds_dir))
    print(json.dumps({"dataset_dir": ds_dir, "bytes": total}))


if __name__ == "__main__":
    main()
