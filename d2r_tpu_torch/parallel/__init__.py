"""Training across processes, one per card (counterpart of
``d2r_tpu/parallel``): ``distributed`` joins the processes and holds the
collectives, ``mesh`` the (data, stage, model) mesh and the tensor- and
pipeline-parallel layout, ``launch`` the localhost launch helpers. Nothing is imported here: the
model's layers import ``distributed``, and ``mesh`` imports the layers."""
