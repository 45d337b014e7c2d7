# Developer entry points. `make test` mirrors the CI invocation.
.PHONY: test test-fast test-gpu smoke bench micro scaling eval native install

test:
	python -m pytest tests/ -q

test-fast:
	python -m pytest tests/ -q -m "not slow"

# Card-only tests (skip on the CPU).
test-gpu:
	JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -q -m gpu

# Main path on one GPU: kernel parity + the CLI configs, one JSON line last.
smoke:
	python chip_smoke.py

bench:
	python bench.py

# Per-kernel device times against the card's peaks (benchmarks/micro.py).
micro:
	python benchmarks/micro.py

# Dist-BA scaling curve over the available devices.
scaling:
	python benchmarks/scaling.py

# Staged evaluation (BASELINE configs 0-10) -> eval_out/.
eval:
	python eval.py

native:
	$(MAKE) -C native

install:
	pip install -e .
