"""The row-sharded frame (``unclerenderer_tpu/parallel``): collective hooks
(``dist.py``) and the frame over a process group (``multichip.py``)."""
