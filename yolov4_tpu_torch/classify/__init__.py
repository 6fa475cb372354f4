"""CSPDarknet53 ImageNet pretraining: the ImageFolder/RandAugment pipeline
and the classifier Trainer."""
