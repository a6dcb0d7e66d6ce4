#!/usr/bin/env bash
# ROADMAP C8: tests/test_torch_cuda.py::test_spmm_forward_is_one_device_operation
# on the card, RUNS times alone in one process (pytest.main in a loop), 5
# times in processes of its own, then WHOLE times inside the whole card
# file (-rA / -rf: every failure's message, which holds the profiled op
# list, or the allocation count and the live threads). From the repository
# root, on a machine with one H100 (about 20 minutes):
#   bash tools/c8_repeat.sh > c8.log 2>&1
T=tests/test_torch_cuda.py::test_spmm_forward_is_one_device_operation
RUNS=${RUNS:-20}
WHOLE=${WHOLE:-3}
export PYTHONPATH=src
echo "== $RUNS in one process"
python - "$T" "$RUNS" <<'PY'
import sys
import pytest
test, runs = sys.argv[1], int(sys.argv[2])
codes = [int(pytest.main(["-q", "-rA", "-p", "no:cacheprovider", test]))
         for _ in range(runs)]
print("exit codes:", codes, "failed:", sum(c != 0 for c in codes))
PY
for i in 1 2 3 4 5; do
  echo "== alone, process $i"
  python -m pytest -q -rA -p no:cacheprovider "$T" 2>&1 | tail -n 5
done
for i in $(seq "$WHOLE"); do
  echo "== whole card file, run $i"
  python -m pytest -q -rf -p no:cacheprovider -m cuda tests/test_torch_cuda.py 2>&1 | tail -n 40
done
