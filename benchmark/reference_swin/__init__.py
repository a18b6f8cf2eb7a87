"""The plain reference of the benchmark's detect -> track configurations whose
backbone is the Swin Transformer (``model.py``), a copy of
``benchmark/reference`` with that backbone added and its imports renamed.

Plain PyTorch and NumPy, in float32 with TF32 off unless a caller asks for a
lower precision (the control): the staging (``preprocess``), the detector
(``model``), its candidates, NMS and RoIAlign (``postprocess``), the tracker
(``tracker``, with the assignment in ``assign``) and the track records
(``records``). It imports nothing of the program under test and takes
nothing it made: the benchmark hands both sides the same raw frames and the
same weights, and the reference works everything else out again.
"""
