# OAKE objects over COCO with OpenAI CLIP ViT-L/14 as the teacher: the
# geometry comes from the checkpoint (width 1024, 24 layers, 16 heads,
# 14-px patches; OADP's surgery halves the stride to 7, a 32 x 32 grid of
# 1,025 tokens a crop). The checkpoint is not in the repository.
_base_ = ['objects_coco.py']

model = dict(checkpoint='pretrained/clip/ViT-L-14.pt')
