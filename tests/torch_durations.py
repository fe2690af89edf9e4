"""Each test file's summed test time from a pytest JUnit XML.

    python tests/torch_durations.py /tmp/_t1.xml [--top 15] [--port]

pytest's ``--junitxml`` gives each test case its setup, call and teardown
time together, so a module fixture counts in the file whose test first
asks for it. Prints the files by summed seconds, largest first (``--port``:
only ``test_torch_*.py``), then the totals: cases, passed, failed, errors,
skipped and the seconds summed over every case (the workers' time, not
the run's wall time).
"""

import argparse
import collections
import xml.etree.ElementTree as ET


def per_file(path):
    """{file: [seconds, cases]} and the outcome counts of the XML at ``path``."""
    files = collections.defaultdict(lambda: [0.0, 0])
    counts = collections.Counter()
    for case in ET.parse(path).getroot().iter("testcase"):
        parts = case.get("classname", "").split(".")
        name = next((p for p in parts if p.startswith("test_")), ".".join(parts))
        files[f"{name}.py"][0] += float(case.get("time", 0.0))
        files[f"{name}.py"][1] += 1
        tags = {child.tag for child in case}
        outcome = next((t for t in ("error", "failure", "skipped") if t in tags), "passed")
        counts[outcome] += 1
    return files, counts


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("xml")
    p.add_argument("--top", type=int, default=0, help="only the largest N files (0: all)")
    p.add_argument("--port", action="store_true", help="only tests/test_torch_*.py")
    args = p.parse_args(argv)
    files, counts = per_file(args.xml)
    rows = sorted(files.items(), key=lambda kv: -kv[1][0])
    if args.port:
        rows = [r for r in rows if r[0].startswith("test_torch_")]
    for name, (secs, n) in rows[:args.top or None]:
        print(f"{secs:9.2f} s  {n:4d}  {name}")
    total = sum(secs for secs, _ in files.values())
    print(f"cases {sum(counts.values())}  passed {counts['passed']}  failed "
          f"{counts['failure']}  errors {counts['error']}  skipped {counts['skipped']}  "
          f"summed {total:.2f} s")


if __name__ == "__main__":
    main()
