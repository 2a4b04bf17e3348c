# Convenience targets (the cloudsc-bundle analogue; ref: cloudsc-bundle:22-48)

.PHONY: all native test test-fast bench sweep clean

all: native

native:
	$(MAKE) -C cloudsc_tpu/native

test: native
	python -m pytest tests/ -q

test-fast: native
	python -m pytest tests/test_golden.py tests/test_triton.py -q

bench:
	python bench.py

sweep:
	python bench/sweep.py

clean:
	$(MAKE) -C cloudsc_tpu/native clean
	find . -name __pycache__ -type d -prune -exec rm -rf {} +
