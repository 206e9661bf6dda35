#!/bin/bash
# Run the test suite in three process groups.
#
# Why not one `pytest tests/`: this platform's XLA CPU backend has
# repeatedly SEGFAULTED inside `backend_compile_and_load` after a few
# hundred compiles in one long-lived process (observed three times, each
# at a DIFFERENT test, always in the compiler — an accumulating-state
# LLVM crash, not a test bug; every file passes in a fresh process).
# Three groups keep per-process compile counts under the observed crash
# horizon while still amortizing fixtures within each group.
#
# Usage: tests/run_suite.sh [group] [extra pytest args...]
#   group ∈ {1,2,3}: run only that group (CI shards the groups into
#   parallel matrix jobs so each stays well inside the job timeout);
#   omitted: run all three sequentially.
set -u
cd "$(dirname "$0")/.."
fail=0

GROUP1="tests/test_adapters_gating.py tests/test_bandpower.py \
        tests/test_calibration.py tests/test_certify.py tests/test_chip_smoke.py \
        tests/test_distributions.py tests/test_docs_execute.py"
GROUP2="tests/test_fft_check.py tests/test_grf.py tests/test_lbfgs.py \
        tests/test_precision.py \
        tests/test_lensing.py tests/test_mesh.py"
GROUP3="tests/test_muse_funnel.py tests/test_newton_varpro.py \
        tests/test_numpyro_adapter.py tests/test_grf_field.py \
        tests/test_ppl.py tests/test_theta_transforms.py"

# guard: every tests/test_*.py must appear in a group — a new test file
# not added above would otherwise silently never run in CI (the
# workflow invokes this script, not `pytest tests/`)
for f in tests/test_*.py; do
  case " $GROUP1 $GROUP2 $GROUP3 " in
    *" $f "*) ;;
    *) echo "ERROR: $f is not in any run_suite.sh group" >&2; fail=1 ;;
  esac
done
[ "$fail" -eq 0 ] || exit 1

run_group() {
  echo "=== pytest group: $* ==="
  python -m pytest -q $* || fail=1
}

sel="${1:-all}"
[ $# -gt 0 ] && shift
case "$sel" in
  1) run_group $GROUP1 "$@" ;;
  2) run_group $GROUP2 "$@" ;;
  3) run_group $GROUP3 "$@" ;;
  all) run_group $GROUP1 "$@"; run_group $GROUP2 "$@"; run_group $GROUP3 "$@" ;;
  *) echo "unknown group '$sel' (expected 1, 2, 3, or no argument)" >&2
     exit 2 ;;
esac

exit $fail
