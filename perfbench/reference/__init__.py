"""The plain reference the benchmark holds the program against: frozen
copies of latentsplat_tpu_torch's modules (the model, the losses, the train
step without remat or bfloat16 sites, the optimizer), with the rasterizer
replaced by a plain tile compositor (`ops/rasterize/plain.py`). It imports
nothing of the program, JAX or the JAX package; the benchmark builds it from
the configuration file's blocks and gives it the same weights and inputs."""
