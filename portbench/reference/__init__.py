"""The plain reference: YOLOv4 and the CSPDarknet53 classifier, their
decode, postprocess, loss and Adam, in plain PyTorch. It imports nothing of
the program under test and takes nothing the program made."""
