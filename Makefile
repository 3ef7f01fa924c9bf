# fugu_tpu build/test entry points
.PHONY: all native test test-gpu bench serve clean

all: native test

native:
	python -m fugu_tpu.native --build

test:
	JAX_PLATFORMS=cpu python -m pytest tests/ -q -n 6

# on a machine with an NVIDIA GPU: the card-only tests and the smoke run
test-gpu:
	FUGU_TEST_GPU=1 python -m pytest tests/ -q -m gpu
	python chip_smoke.py

bench:
	python bench.py

serve:
	python -m fugu_tpu serve --port 3301

clean:
	rm -rf .bench_cache .jax_cache native/libfugu_native.so
	find . -name __pycache__ -type d -exec rm -rf {} +
