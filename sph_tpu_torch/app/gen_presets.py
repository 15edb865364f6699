"""Write one KV preset for each of the 14 art presets (counterpart of
``scripts/gen_presets.py``).

    python -m sph_tpu_torch.app.gen_presets <out_dir>

Each file is ``gather_preset`` of the art preset applied to the default
settings, written by ``io.presets.save_file`` under the preset's sanitized
name, so the files are byte-identical to the repo's ``presets/*.txt``.
Re-running reproduces identical files.  The output directory is required:
the generator never writes into ``presets/`` unless asked to.  It does no
device work.
"""
from __future__ import annotations

import argparse
import os
from typing import List, Optional

from sph_tpu_torch.io import presets as pio
from sph_tpu_torch.scene.art_presets import ART_PRESET_NAMES, apply_art_preset
from sph_tpu_torch.scene.settings import SceneSettings, gather_preset


def main(argv: Optional[List[str]] = None) -> List[str]:
    """Write the 14 preset files into the output directory (made if
    missing); returns their paths in art-preset order."""
    ap = argparse.ArgumentParser(prog="python -m sph_tpu_torch.app.gen_presets",
                                 description="Write one KV preset for "
                                 "each of the 14 art presets.")
    ap.add_argument("out_dir", help="directory to write the presets into")
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    paths = []
    for i, name in enumerate(ART_PRESET_NAMES):
        s = apply_art_preset(SceneSettings(), i)
        path = os.path.join(args.out_dir, f"{pio.sanitize_name(name)}.txt")
        if not pio.save_file(path, gather_preset(s)):
            raise OSError(f"could not write {path}")
        print(f"wrote {path}")
        paths.append(path)
    return paths


if __name__ == "__main__":
    main()
