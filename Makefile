# Common targets (see CLAUDE.md for environment notes)
.PHONY: test test-fast test-gpu smoke bench examples native clean

# CPU suite env, set up-front (the conftest re-exec does the same for bare
# `pytest` invocations)
CPU_TEST_ENV = env JAX_PLATFORMS=cpu \
	XLA_FLAGS=--xla_force_host_platform_device_count=8 TPUMCIA_REEXECED=1

test:
	$(CPU_TEST_ENV) python -m pytest tests/ -q

# quick feedback loop: skips the compile/train-heavy tests (marked `slow`)
test-fast:
	$(CPU_TEST_ENV) python -m pytest tests/ -q -m "not slow"

# the gpu-marked tests, on the card
test-gpu:
	TPUMCIA_TEST_BACKEND=native python -m pytest tests/ -m gpu -q

# end-to-end check on one GPU (chip_smoke.py --four for four)
smoke:
	python chip_smoke.py

bench:
	python bench.py

examples:
	python examples/notebook_workflow.py /tmp/tpumcia_examples
	python examples/cytometry_h5.py
	python examples/cnn_workflow.py
	python examples/streaming_scale.py

native:
	g++ -O3 -march=native -shared -fPIC -std=c++17 -pthread \
		native/packer.cpp -o native/libmcia_packer.so

clean:
	rm -rf .jax_cache native/libmcia_packer.so
