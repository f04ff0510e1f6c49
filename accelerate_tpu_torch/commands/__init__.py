"""The command line: the port of `accelerate_tpu.commands`.

``python -m accelerate_tpu_torch.commands.launch [flags] script.py [args]``
starts one process a device with the torchrun environment (`launch`);
``python -m accelerate_tpu_torch.commands.cli`` holds ``launch``, ``config``
and ``config-update`` (`config`). The reference's other commands (``env``,
``test``, ``estimate-memory``, ``merge-weights``, ``tpu-config``) and its
pod, ssh, gcloud and SageMaker launches are not ported (ROADMAP Queue 1,
item 21.3).
"""
