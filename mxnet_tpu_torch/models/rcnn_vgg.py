"""Faster R-CNN VGG16's test network (parity: MXNet 1.0's
example/rcnn/rcnn/symbol/symbol_vgg.py, ``get_vgg_test``, at
rcnn/config.py's TEST settings: anchors at scales (8, 16, 32) and ratios
(0.5, 1, 2) on a stride-16 feature map, 6,000 proposals before the
suppression at 0.7 and 300 after, a minimum size of 16; ROIPooling 7 x 7
at 1/16, fc6/fc7 4096, 21 classes).

The widths are arguments so that a test can build the same graph
narrow; the defaults are the published ones.  ``batch_images`` above 1
uses ``MultiProposal``, whose rois carry each picture's index.  Outputs:
``rois`` [batch * post_nms, 5], ``cls_prob`` [batch, post_nms, classes]
and ``bbox_pred`` [batch, post_nms, 4 * classes].
"""
from __future__ import annotations

from .. import symbol as sym

VGG16_STAGES = (2, 2, 3, 3, 3)
VGG16_FILTERS = (64, 128, 256, 512, 512)


def get_vgg_conv(data, filters=VGG16_FILTERS):
    """VGG16's conv1_1 .. relu5_3 (four 2x2/2 max pools)."""
    net = data
    for stage, (reps, f) in enumerate(zip(VGG16_STAGES, filters)):
        for rep in range(reps):
            name = "%d_%d" % (stage + 1, rep + 1)
            net = sym.Convolution(net, kernel=(3, 3), pad=(1, 1),
                                  num_filter=f, workspace=2048,
                                  name="conv" + name)
            net = sym.Activation(net, act_type="relu", name="relu" + name)
        if stage < 4:
            net = sym.Pooling(net, pool_type="max", kernel=(2, 2),
                              stride=(2, 2), name="pool%d" % (stage + 1))
    return net


def get_vgg_test(num_classes=21, num_anchors=9, batch_images=1,
                 filters=VGG16_FILTERS, rpn_filters=512, fc_hidden=4096,
                 rpn_pre_nms_top_n=6000, rpn_post_nms_top_n=300,
                 rpn_nms_thresh=0.7, rpn_min_size=16, feat_stride=16,
                 anchor_scales=(8, 16, 32), anchor_ratios=(0.5, 1, 2)):
    data = sym.var("data")
    im_info = sym.var("im_info")
    relu5_3 = get_vgg_conv(data, filters)
    rpn_conv = sym.Convolution(relu5_3, kernel=(3, 3), pad=(1, 1),
                               num_filter=rpn_filters, name="rpn_conv_3x3")
    rpn_relu = sym.Activation(rpn_conv, act_type="relu", name="rpn_relu")
    rpn_cls_score = sym.Convolution(rpn_relu, kernel=(1, 1), pad=(0, 0),
                                    num_filter=2 * num_anchors,
                                    name="rpn_cls_score")
    rpn_bbox_pred = sym.Convolution(rpn_relu, kernel=(1, 1), pad=(0, 0),
                                    num_filter=4 * num_anchors,
                                    name="rpn_bbox_pred")
    rpn_cls_score_reshape = sym.Reshape(rpn_cls_score, shape=(0, 2, -1, 0),
                                        name="rpn_cls_score_reshape")
    rpn_cls_prob = sym.SoftmaxActivation(rpn_cls_score_reshape,
                                         mode="channel", name="rpn_cls_prob")
    rpn_cls_prob_reshape = sym.Reshape(rpn_cls_prob,
                                       shape=(0, 2 * num_anchors, -1, 0),
                                       name="rpn_cls_prob_reshape")
    proposal = sym.contrib.Proposal if batch_images == 1 \
        else sym.contrib.MultiProposal
    rois = proposal(cls_prob=rpn_cls_prob_reshape, bbox_pred=rpn_bbox_pred,
                    im_info=im_info, name="rois", feature_stride=feat_stride,
                    scales=tuple(anchor_scales),
                    ratios=tuple(anchor_ratios),
                    rpn_pre_nms_top_n=rpn_pre_nms_top_n,
                    rpn_post_nms_top_n=rpn_post_nms_top_n,
                    threshold=rpn_nms_thresh, rpn_min_size=rpn_min_size)
    pool5 = sym.ROIPooling(relu5_3, rois, pooled_size=(7, 7),
                           spatial_scale=1.0 / feat_stride, name="roi_pool5")
    net = sym.Flatten(pool5, name="flatten")
    for i in (6, 7):
        net = sym.FullyConnected(net, num_hidden=fc_hidden, name="fc%d" % i)
        net = sym.Activation(net, act_type="relu", name="relu%d" % i)
        net = sym.Dropout(net, p=0.5, name="drop%d" % i)
    cls_score = sym.FullyConnected(net, num_hidden=num_classes,
                                   name="cls_score")
    cls_prob = sym.softmax(cls_score, name="cls_prob")
    bbox_pred = sym.FullyConnected(net, num_hidden=num_classes * 4,
                                   name="bbox_pred")
    cls_prob = sym.Reshape(cls_prob, shape=(batch_images, -1, num_classes),
                           name="cls_prob_reshape")
    bbox_pred = sym.Reshape(bbox_pred,
                            shape=(batch_images, -1, 4 * num_classes),
                            name="bbox_pred_reshape")
    return sym.Group([rois, cls_prob, bbox_pred])
