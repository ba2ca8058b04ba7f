"""Derive a configuration file (its published key layout: keys, shapes,
dtypes and the scale of each draw) from the port's inits and export
layouts, through the family's adapter (``config_file``).

Run once when a configuration is added; its output is frozen as data in
``gpubench/configs/<name>.json``, so the benchmark's weights do not move
when the port's own trees change later.

    python -m gpubench.tools.derive_layout [--family flux] flux-dev
"""

from __future__ import annotations

import argparse
import json
import os

from gpubench import families, harness


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--family", default=families.DEFAULT)
    p.add_argument("names", nargs="+")
    args = p.parse_args(argv)
    fam = families.adapter({"family": args.family})
    for name in args.names:
        path = os.path.join(harness.ROOT, "gpubench", "configs",
                            f"{name}.json")
        with open(path, "w") as f:
            json.dump(fam.config_file(name), f, separators=(",", ":"))
            f.write("\n")


if __name__ == "__main__":
    main()
