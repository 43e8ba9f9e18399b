"""Write the VG-shaped JPEG fixture the port's tests and chip_smoke.py read.

  python tests/fixtures_torch/vg_jpeg/make_fixture.py

Writes, beside this file: ``images/<id>.jpg`` and ``relationships.json``, a
grounded synthetic corpus of NUM_IMAGES 500 x 375 q75 JPEGs from
``sgg.data.synthetic.write_synthetic_vg_corpus(..., grounded=True)``; and
``decoded_224.npz``, ``sgg.native.decode_batch`` of the first NUM_DECODED of
them at 224 px (``images`` uint8 [n, 224, 224, 3] and ``names``), the
reference decoder's bytes. It needs the reference package and PIL, so it runs
where both are installed, not on the card's machine and not in the tests.
"""

import json
import os
import shutil
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))

NUM_IMAGES, NUM_DECODED, SEED, SIZE = 32, 8, 0, 224


def main() -> None:
    from sgg import native
    from sgg.data.synthetic import write_synthetic_vg_corpus

    shutil.rmtree(os.path.join(HERE, "images"), ignore_errors=True)
    info = write_synthetic_vg_corpus(HERE, NUM_IMAGES, seed=SEED, grounded=True,
                                     log_every=0)
    with open(os.path.join(HERE, "relationships.json")) as f:
        ids = [e["image_id"] for e in json.load(f)][:NUM_DECODED]
    names = [f"{i}.jpg" for i in ids]
    images = native.decode_batch([os.path.join(HERE, "images", n) for n in names], SIZE)
    np.savez_compressed(os.path.join(HERE, "decoded_224.npz"), images=images,
                        names=np.array(names))
    total = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(HERE)
                for f in fs)
    print(f"{info['num_images']} images, {info['num_rels']} relationships, "
          f"{NUM_DECODED} decoded at {SIZE} px; {total / 1e6:.2f} MB in {HERE}")


if __name__ == "__main__":
    main()
