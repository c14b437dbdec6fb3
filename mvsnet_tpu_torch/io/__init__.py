"""File-format IO: local and remote paths, cam.txt and camera.json cameras,
image and depth PNGs (copies of mvsnet_tpu/io/{filesystem,cams,images}.py).

Nothing here imports an image codec or fsspec when the module is imported:
the machines that run the port on a card may have neither."""
