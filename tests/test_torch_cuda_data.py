"""The port's RLDS reader on the card: its nvJPEG route (the route it
builds where the machine has no libjpeg) decodes a frame at each chroma
subsampling close to libjpeg's decode. Needs an NVIDIA GPU and imports
nothing of jax; run it where the card is with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_data.py -q -s

tests/fixtures_rlds/subsampling.npz holds a 67 x 101 frame encoded by
libjpeg at 4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1, 4:1:0 and in grayscale,
beside PIL's (libjpeg's) decode of each. nvJPEG returns each as planes that
the host upsamples and converts as libjpeg does (the CPU tests hold that
host half to libjpeg bit for bit), so only the IDCT differs: within
chip_smoke.py's golden bounds, 6 / 0.1 uint8 steps (max / mean). nvJPEG's
own RGB output, which upsamples the chroma otherwise, read 48 / 1.90 at
4:4:0 on an H100, and a chroma plane read at a wrong factor is further off.
"""
import os

import numpy as np
import pytest
import torch

from spatialvla_tpu_torch.data import native

pytestmark = pytest.mark.cuda

SUBSAMPLING = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures_rlds",
                           "subsampling.npz")
BOUND = (6, 0.1)  # (max, mean) |difference|, uint8 steps


@pytest.fixture(autouse=True)
def _needs_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the nvJPEG route decodes on the card")


@pytest.mark.parametrize("kind", ["444", "422", "420", "440", "411", "410", "gray"])
def test_nvjpeg_decodes_each_subsampling(kind):
    route = native.decode_path()
    if route == "libjpeg":
        pytest.skip("this machine has libjpeg: the reader builds its libjpeg route")
    assert route == "nvjpeg", native.build_error()
    z = np.load(SUBSAMPLING)
    jpeg, want = z[kind + "/jpeg"].tobytes(), z[kind + "/rgb"]
    got = native.decode_jpeg_resize(jpeg, *want.shape[:2])
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    print(f"nvjpeg {kind}: max |diff| {int(diff.max())}, mean {float(diff.mean()):.4f}")
    assert diff.max() <= BOUND[0] and diff.mean() <= BOUND[1]
