"""Write the JPEG fixtures of `tests/test_torch_jpeg.py` and `chip_smoke.py`
with PIL, and PIL's decode of each into `pil_decodes.npz`.

    python tests/data/jpeg/make_fixtures.py

The images are frame 0 of the golden protocol (640x480 spheres, seed 2) as
the port's make_synth renders its colour: 4:2:0 at quality 75, 4:4:4 at
quality 90 with a restart marker every MCU row, and the greyscale-textured
render as a one-component JPEG at quality 60. The card's machine has no PIL,
so the smoke holds the port's decoder to the stored arrays.
"""

import os
import sys

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))

from gradient_sdf_tpu_torch.apps import make_synth  # noqa: E402
from gradient_sdf_tpu_torch.data import synth  # noqa: E402

FIXTURES = {
    "golden_420.jpg": dict(quality=75, subsampling=2),
    "golden_444.jpg": dict(quality=90, subsampling=0, restart_marker_rows=1),
    "golden_grey.jpg": dict(quality=60),
}


def main():
    world = synth.random_spheres(seed=2)
    R, t = synth.orbit_poses(n=6, radius=2.0, arc=np.deg2rad(4.0))[0]
    K = synth.KINECT_K
    flat = make_synth.render_color(world, R, t, K, 640, 480).numpy()
    grey = make_synth.render_color(world, R, t, K, 640, 480,
                                   gray_texture=True).numpy()[..., 0]
    decodes = {}
    for name, kw in FIXTURES.items():
        img = grey if "grey" in name else flat
        arr = np.clip(img * 255.0, 0, 255).astype(np.uint8)
        path = os.path.join(HERE, name)
        Image.fromarray(arr).save(path, **kw)
        with Image.open(path) as im:
            decodes[name] = np.asarray(im)
    np.savez_compressed(os.path.join(HERE, "pil_decodes.npz"), **decodes)


if __name__ == "__main__":
    main()
