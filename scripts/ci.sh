#!/bin/bash
# One-command check + build (L10 packaging/CI; reference analog:
# .github/workflows/bazel-test.yml + //python/biograph:package).
#
#   scripts/ci.sh quick   -> `-m "not slow"` subset (default; < ~5 min)
#   scripts/ci.sh full    -> whole suite incl. golden-data e2e
#   scripts/ci.sh wheel   -> build sdist+wheel from pyproject into dist/
#
# Tests force the CPU backend with 8 virtual devices via tests/conftest.py,
# so this runs identically on any host (no accelerator needed).
set -euo pipefail
cd "$(dirname "$0")/.."

mode="${1:-quick}"
case "$mode" in
  quick)
    python -m pytest tests/ -q -m "not slow" ;;
  full)
    python -m pytest tests/ -q ;;
  wheel)
    # --no-build-isolation: works offline with the ambient setuptools
    python -m pip wheel --no-deps --no-build-isolation -w dist .
    ls -l dist/ ;;
  *)
    echo "usage: scripts/ci.sh [quick|full|wheel]" >&2; exit 2 ;;
esac
