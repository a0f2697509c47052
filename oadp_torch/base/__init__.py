from .categories import Categories, Globals, coco, lvis

__all__ = ['Categories', 'Globals', 'coco', 'lvis']
